"""The zoo's training steps sharded over 2 ranks (gloo on the CPU, one torch
thread each, a file:// store; tests/test_torch_ddp.py::sharded_steps)
against the port's own one-process step on the global batch, to the zoo's
bars (tests/test_torch_dimp_train.py::assert_step_matches): loss and stats
within 1e-5 relative, trained leaves within 1e-5 relative L2, frozen
leaves bit-equal; every rank reports the same stats.

- dimp: DiMP-50 at 96 px, B=2; the proposals' normal noise drawn for the
  global batch from the step's generator, each rank keeping its rows;
  the IoU MSE and LBHinge are means over equal rows.
- stark bbox and score: the narrow STARK-SPT of
  tests/test_torch_zoo_train.py (weight seed 1), B=2 and B=4; the score
  stage's negatives are the global batch rolled by one, so rank 1's first
  negative is rank 0's last search, and only the score head trains.
- mdnet: MDNet-dual, 4 positive and 8 negative patches a sample from 96-px
  searches, B=2; the patch boxes' noise drawn for the global batch.
- lwl: the narrow LWL of tests/test_torch_lwl_train.py at 64 px, B=2:
  one filter learned from the whole batch's train frames (the learner's
  sums over the global batch, each rank's regulariser scaled by
  1 / sqrt(world)), differentiated through. Batch seed 2: at seed 3 the
  one-process step itself moves 29,916 trained elements by more than
  lr / 10 under a 1e-7 relative change of the crops (9.3e-5 relative L2),
  so no comparison holds there; at seeds 0 and 9 the sharded step moves
  ~6,000 trunk elements past lr / 10 (4.1e-5 and 8.5e-5 relative L2),
  Adam's first step (~lr sign(g)) on gradients within rounding of zero
  that the batch-of-one convolutions sum in another order; at seeds 2, 6
  and 7 none moves, 6e-8 relative L2.
"""

import test_torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mmtrack_torch.models.lwl import LWLNet, init_lwl_weights  # noqa: E402
from mmtrack_torch.train import run  # noqa: E402
from test_torch_ddp import assert_ranks_match, sharded_steps, single_step  # noqa: E402
from test_torch_dimp_train import LR, WD, batch as dimp_batch  # noqa: E402
from test_torch_lwl_train import NET, sampler_batch  # noqa: E402
from test_torch_zoo_train import BRIDGES, batch as zoo_batch, flax_tree, port_model  # noqa: E402

OPT = dict(lr=LR, weight_decay=WD)


def stark_spec(stage: str) -> dict:
    model = port_model("stark", stage)
    model.load_state_dict(BRIDGES["stark"](flax_tree("stark", stage, seed=1)["params"]))
    return {"model": model, "mask": run.zoo_trainable_mask(model, "stark", stage), "opt": OPT,
            "factory": ("mmtrack_torch.train.zoo_actors", "make_stark_train_step",
                        {"stage": stage}),
            "batch": zoo_batch(10, "stark", b=4 if stage == "score" else 2)}


def mdnet_batch(seed: int, b: int = 2, size: int = 96) -> dict:
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.2, 0.5, (b, 2))
    wh = rng.uniform(0.15, 0.3, (b, 2))
    return {"template": rng.uniform(-1, 1, (b, 32, 32, 6)).astype(np.float32),
            "search": rng.uniform(-1, 1, (b, size, size, 6)).astype(np.float32),
            "search_anno": np.concatenate([xy, wh], 1).astype(np.float32)}


def specs() -> dict:
    lwl = init_lwl_weights(LWLNet(**NET), 0)
    return {
        "dimp": {"model": run.build_zoo_model("dimp", "", 0, "cpu"), "mask": None, "opt": OPT,
                 "factory": ("mmtrack_torch.train.dimp_actor", "make_dimp_train_step",
                             {"image_sz": 96, "seed": 3}),
                 "batch": dimp_batch(2)},
        "stark_bbox": stark_spec("bbox"),
        "stark_score": stark_spec("score"),
        "mdnet": {"model": run.build_zoo_model("mdnet", "", 0, "cpu"), "mask": None, "opt": OPT,
                  "factory": ("mmtrack_torch.train.zoo_actors", "make_mdnet_train_step",
                              {"n_pos": 4, "n_neg": 8, "seed": 3}),
                  "batch": mdnet_batch(4)},
        "lwl": {"model": lwl, "mask": None, "opt": OPT,
                "factory": ("mmtrack_torch.train.zoo_actors", "make_lwl_train_step",
                            {"image_sz": 64, "template_factor": 6.0}),
                "batch": sampler_batch(2)},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.manual_seed(0)
    by_name = specs()
    starts = {k: {n: v.clone() for n, v in s["model"].state_dict().items()}
              for k, s in by_name.items()}
    sharded = sharded_steps(str(tmp_path_factory.mktemp("zoo")), list(by_name.values()))
    return by_name, starts, dict(zip(by_name, sharded))


@pytest.mark.parametrize("name", ["dimp", "stark_bbox", "stark_score", "mdnet", "lwl"])
def test_two_rank_zoo_step_matches_one_process(runs, name):
    by_name, starts, sharded = runs
    spec = by_name[name]
    want_stats, want = single_step(spec)
    rank_stats, got = sharded[name]
    mask = spec["mask"]
    trained = set(starts[name]) if mask is None else {k for k, v in mask.items() if v}
    assert_ranks_match(rank_stats, got, want_stats, want, starts[name], trained, lr=LR)
