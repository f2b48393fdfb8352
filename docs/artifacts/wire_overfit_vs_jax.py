"""The wire tool's head overfit in both packages on the CPU, longer than
the test runs it: tools/wire_metric_ab.py::overfit_head_on_device
against mmtrack_torch/eval/wire_metric_ab.py::overfit_head on the same
flax weights of a ViPT with a narrow trunk (embed `embed_dim`, 32 by
default, in max(embed_dim / 64, 2) heads; 12 blocks, 128 / 256 crops, f32; deep_rgbd's is
768 wide) and a head of `head_channel` channels (16 by default;
deep_rgbd's head has 256), 2 training sequences of a 2 x 21 corpus. Each
prints its loss every tenth of the steps and the calibration delta; then,
for each package, the share of the trained samples' score and size cells
that sit at the head's sigmoid clamp (<= 1e-4 or >= 1 - 1e-4), where the
loss has no gradient. A one-off comparison, not a test (~70 s on the CPU
at 300 steps and the default widths, ~5 min at 600 steps, 256 and 384):

    JAX_PLATFORMS=cpu python docs/artifacts/wire_overfit_vs_jax.py [steps] [head_channel] \
        [embed_dim]
"""
import contextlib
import io
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
import jax
import jax.numpy as jnp
import numpy as np
import torch

import tools.wire_metric_ab as jax_wire
from mmtrack_tpu.models import vipt as jax_vipt
from mmtrack_tpu.trackers.vipt_tracker import ViPTRuntime as JaxRuntime
from mmtrack_torch.eval import wire_metric_ab as wire
from mmtrack_torch.models import vipt
from mmtrack_torch.models.convert import vipt_state_dict_from_flax

LO, HI = 1e-4, 1 - 1e-4


def at_clamp(score: np.ndarray, size: np.ndarray) -> dict:
    def share(v):
        return float(np.mean((v <= LO * (1 + 1e-3)) | (v >= HI)))

    return {"score_cells_at_clamp": share(score), "size_cells_at_clamp": share(size)}


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    embed = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    width = dict(embed_dim=embed, num_heads=max(embed // 64, 2),
                 head_channel=int(sys.argv[2]) if len(sys.argv) > 2 else 16)
    log_every = max(steps // 10, 1)
    with tempfile.TemporaryDirectory() as root:
        jax_wire.FIXTURE_DIR = root
        wire.ensure_fixtures(root, 2, 21)
        data = wire.head_crops(root, 2, 21)
        jm = jax_vipt.ViPTrack(**width)
        keep = JaxRuntime().ce_keep_lens
        params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 128, 128, 6)),
                                           jnp.zeros((1, 256, 256, 6)), None, keep))(
            jax.random.PRNGKey(0))
        port = vipt.ViPTrack(**width).eval()
        port.load_state_dict(vipt_state_dict_from_flax(jax.tree.map(np.asarray,
                                                                    params["params"])))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            trained = jax_wire.overfit_head_on_device(jm, params, 2, 21, steps,
                                                      log_every=log_every)
        print("JAX\n" + printed.getvalue(), flush=True)
        apply = jax.jit(lambda p, z, x: jm.apply(p, z, x, None, keep))
        outs = [apply(trained, data["z"][i:i + 1], data["x"][i:i + 1])
                for i in range(len(data["z"]))]
        print("JAX", at_clamp(np.stack([np.asarray(o["score_map"]) for o in outs]),
                              np.stack([np.asarray(o["size_map"]) for o in outs])), flush=True)
        print("port", flush=True)
        wire.overfit_head(port, root, 2, 21, steps, log_every=log_every)
        with torch.no_grad():
            outs = [port(torch.from_numpy(data["z"][i:i + 1]),
                         torch.from_numpy(data["x"][i:i + 1]), None, keep)
                    for i in range(len(data["z"]))]
        print("port", at_clamp(np.stack([o["score_map"].numpy() for o in outs]),
                               np.stack([o["size_map"].numpy() for o in outs])), flush=True)
