"""The port's benchmark suite (`python -m mmtrack_torch.eval.benchmark_suite`)
and demo (`python -m mmtrack_torch.demo`) on the CPU, each in a process
where jax, flax and the JAX package cannot be imported.

- The mosse suite on the synthetic sequence: suite_report.json equal to
  tools/benchmark_suite.py's (run here in-process) on the same sequence.
- The suite over a DepthTrack layout (3 sequences) for mosse: its line
  equals the recipe's own `run_ope --tracker mosse --analyze` report (SR,
  PR to 2 decimals in percent, F to 4), and its result files equal
  run_ope's byte for byte.
- The demo with --dashboard --pause over 5 synthetic frames: the URL it
  prints serves /state (paused, the titles registered) and /data; one
  POST of 'step' advances one frame, 'resume' runs it to the end; the
  visualizer's index and frames are written.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

pytest.importorskip("torch")

from test_torch_ddp import BLOCK_JAX, ope_fixture, rank_env  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def env():
    e = rank_env(0, 1)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        e.pop(k)
    return e


def run_blocked(tmp_path, module: str, args: list) -> str:
    code = BLOCK_JAX + (f"import runpy\nsys.argv = ['{module}'] + sys.argv[1:]\n"
                        f"runpy.run_module('{module}', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=str(tmp_path), env=env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_mosse_suite_matches_jax_suite(tmp_path, monkeypatch):
    args = ["--trackers", "mosse", "--synthetic", "--frames", "8"]
    run_blocked(tmp_path, "mmtrack_torch.eval.benchmark_suite",
                args + ["--device", "cpu", "--results_root", str(tmp_path / "port")])
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_benchmark_suite", os.path.join(REPO, "tools", "benchmark_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["benchmark_suite.py", *args, "--results_root",
                                      str(tmp_path / "jax")])
    mod.main()
    reports = [json.loads((tmp_path / side / "SYNTH" / "suite_report.json").read_text())
               for side in ("port", "jax")]
    assert reports[0] == reports[1] and list(reports[0]) == ["mosse"]


def test_suite_line_equals_run_ope_report(tmp_path):
    from mmtrack_torch.eval import run_ope

    ope_fixture(str(tmp_path / "data"))
    common = ["--dataset", "DepthTrack", "--dataset_root", str(tmp_path / "data"),
              "--device", "cpu"]
    out = run_blocked(tmp_path, "mmtrack_torch.eval.benchmark_suite",
                      common + ["--trackers", "mosse", "--results_root", str(tmp_path / "suite")])
    assert "suite report:" in out
    assert run_ope.main(common + ["--tracker", "mosse", "--analyze", "--results_root",
                                  str(tmp_path / "ope")]) == 0
    line = json.loads((tmp_path / "suite" / "DepthTrack" / "suite_report.json").read_text())
    rep = json.loads((tmp_path / "ope" / "DepthTrack" / "mosse_report.json").read_text())
    assert line == {"mosse": {"SR": round(rep["ope"]["success_auc"] * 100, 2),
                              "PR": round(rep["ope"]["precision_20px"] * 100, 2),
                              "F": round(rep["fscore"]["fscore"], 4)}}
    for seq in ("seq0", "seq1", "seq2"):
        a = tmp_path / "suite" / "DepthTrack" / "mosse" / f"{seq}.txt"
        b = tmp_path / "ope" / "DepthTrack" / "mosse" / f"{seq}.txt"
        assert a.read_bytes() == b.read_bytes()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _post(url, action):
    req = urllib.request.Request(url + "control", data=json.dumps({"action": action}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _wait_state(url, pred, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        s = _get(url + "state")
        if pred(s):
            return s
        time.sleep(0.05)
    raise AssertionError(f"dashboard state never reached: {s}")


def test_demo_dashboard_pause_step_resume(tmp_path):
    code = BLOCK_JAX + ("import runpy\nsys.argv = ['mmtrack_torch.demo'] + sys.argv[1:]\n"
                        "runpy.run_module('mmtrack_torch.demo', run_name='__main__')\n")
    e = env()
    e["PYTHONUNBUFFERED"] = "1"
    proc = subprocess.Popen([sys.executable, "-c", code, "--tracker", "mosse", "--frames", "5",
                             "--dashboard", "--pause", "--device", "cpu", "--out",
                             str(tmp_path / "demo")], cwd=str(tmp_path), env=e,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"(http://127\.0\.0\.1:\d+/)", line)
        assert m, line + proc.stderr.read()
        url = m.group(1)
        s = _wait_state(url, lambda s: s["frame"] == 1 and "Status" in s["titles"])
        assert s["paused"] and sorted(s["titles"]) == ["Status", "Tracking"]
        assert _get(url + "data?title=Status")["info"]["frame"] == "1"
        assert _get(url + "data?title=Tracking")["jpeg"]
        _post(url, "step")
        _wait_state(url, lambda s: s["frame"] == 2)
        _post(url, "resume")
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert [ln for ln in out.splitlines() if ln.startswith("frame ")][-1].startswith("frame 4:")
    files = sorted(os.listdir(tmp_path / "demo"))
    assert files == ["frame_00000.jpg", "frame_00001.jpg", "frame_00002.jpg", "frame_00003.jpg",
                     "frame_00004.jpg", "index.html"]
