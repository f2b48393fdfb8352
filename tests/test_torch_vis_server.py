"""The port's debug dashboard (mmtrack_torch/vis_server.py) against
mmtrack_tpu/vis_server.py on the CPU, over HTTP on localhost.

- The same register calls (a tracking overlay with a box list and a
  segmentation, a heatmap, a histogram, a line plot, a CHW float image, an
  info dict, text, and a call above the debug level that both drop) give
  equal JSON on /state and on /data for every title, JPEG bytes included;
  the port reads tensors (f32 and bf16) to the host once, at register, as
  JAX reads arrays.
- Pause and step: a dashboard started paused holds wait_if_paused until a
  POST of 'step' releases exactly one frame; 'pause' toggles, 'resume'
  runs; unknown paths answer 404.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmtrack_tpu import vis_server as jax_vis_server  # noqa: E402
from mmtrack_torch import vis_server  # noqa: E402


def get(dash, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{dash.port}{path}", timeout=10) as r:
        return json.loads(r.read())


def post(dash, action):
    req = urllib.request.Request(f"http://127.0.0.1:{dash.port}/control",
                                 data=json.dumps({"action": action}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def calls(as_tensor):
    rng = np.random.RandomState(0)
    frame = rng.randint(0, 255, (48, 64, 6)).astype(np.uint8)
    seg = rng.rand(48, 64) > 0.7
    heat = rng.rand(8, 8).astype(np.float32)
    image = rng.rand(3, 20, 30).astype(np.float32)
    t = torch.from_numpy if as_tensor else (lambda a: a)
    return [
        ((t(frame), [[4.0, 5.0, 20.0, 18.0], [30.2, 10.7, 12.0, 9.0]], t(seg)), "tracking", 1,
         "Tracking"),
        (t(heat), "heatmap", 1, "Score Map"),
        (torch.from_numpy(heat).bfloat16() if as_tensor
         else torch.from_numpy(heat).bfloat16().float().numpy(), "heatmap", 1, "bf16"),
        (t(heat.ravel()), "histogram", 1, "Hist"),
        ([0.1, 0.4, 0.2, 0.9], "lineplot", 1, "Loss"),
        (t(image), "image", 1, "Image"),
        ({"frame": 3, "score": 0.5}, "info_dict", 1, "Status"),
        ("hello", "text", 1, "Note"),
        ("dropped", "text", 2, "Deep"),
    ]


def test_dashboard_json_matches_jax():
    port = vis_server.DebugDashboard(log=None)
    ref = jax_vis_server.DebugDashboard(log=None)
    try:
        for dash, as_tensor in ((port, True), (ref, False)):
            for c in calls(as_tensor):
                dash.register(*c)
        state = get(port, "/state")
        assert state == get(ref, "/state")
        assert sorted(state["titles"]) == ["Hist", "Image", "Loss", "Note", "Score Map",
                                           "Status", "Tracking", "bf16"]
        for title in state["titles"]:
            q = "/data?title=" + urllib.parse.quote(title)
            assert get(port, q) == get(ref, q), title
        assert get(port, "/data?title=Tracking")["jpeg"]
        with pytest.raises(urllib.error.HTTPError):
            get(port, "/nothing")
        with urllib.request.urlopen(f"http://127.0.0.1:{port.port}/", timeout=10) as r:
            assert b"mmtrack_torch debug" in r.read()
    finally:
        port.close()
        ref.close()


def test_pause_and_step():
    dash = vis_server.DebugDashboard(pause_mode=True, log=None)
    done = []

    def loop():
        for i in range(3):
            dash.wait_if_paused(poll=0.01)
            done.append(i)

    th = threading.Thread(target=loop, daemon=True)
    try:
        th.start()
        time.sleep(0.2)
        assert done == [] and get(dash, "/state")["paused"]
        post(dash, "step")
        deadline = time.time() + 5
        while len(done) < 1 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert done == [0]
        assert post(dash, "pause") == {"paused": False}
        assert post(dash, "pause") == {"paused": True}
        assert post(dash, "resume") == {"paused": False}
        th.join(timeout=5)
        assert done == [0, 1, 2] and get(dash, "/state")["frame"] == 3
    finally:
        dash.close()
