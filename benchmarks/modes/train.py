"""Prompt tuning: the program's training step (forward, loss, backward,
clip, AdamW over the prompt parameters) on a pool of batches made on the
device, cycled.

Set-up builds the one training state and drives it through its first
three steps, on three different batches, through the window's own call:
those steps warm every shape, and their losses, the first step's
gradient (read back from AdamW's first moment, which after one step is
(1 - beta1) times the clipped gradient) and the parameters' change after
the three are what the reference follows. The window then goes on from
step four with the same state.
"""

from __future__ import annotations

import time

import torch

from benchmarks import compare, system, traffic, weights
from benchmarks.reference import vipt as ref
from benchmarks.reference.quant import fp8
from benchmarks.seeds import sub_seed

FIRST_STEPS = 3
BETA1 = 0.9


class Cell:
    unit = "samples"

    def __init__(self, cfg, traffic_p, seed, device):
        self.cfg, self.p, self.seed, self.device = cfg, traffic_p, seed, device

    def setup(self) -> None:
        from mmtrack_torch.models.vipt import generate_ctr_mask
        from mmtrack_torch.ops.ce import ce_keep_schedule
        from mmtrack_torch.train.optim import build_optimizer, prompt_only_mask
        from mmtrack_torch.train.train_step import TrainState, make_train_step

        cfg, p, dev, tr = self.cfg, self.p, self.device, self.cfg["train"]
        if dev.type == "cuda":
            system.load_kernels()
        self.params = weights.make(cfg, self.seed, dev)
        model = system.model(cfg, dev, train=True)
        system.load(model, self.params)
        self.batches = traffic.train_batches(p, cfg, self.seed, dev)
        stride = cfg["model"]["patch_size"]
        Tz, Tx = cfg["template"]["size"], cfg["search"]["size"]
        keep = ce_keep_schedule((Tx // stride) ** 2, tuple(cfg["ce"]["loc"]),
                                tuple(cfg["ce"]["keep_ratio"]))
        mask = generate_ctr_mask(Tz // stride, cfg["ce"]["template_range"], device=dev)
        w = tr["loss_weights"]
        self.drop_seed = sub_seed(self.seed, "drop_path")
        self.step = make_train_step(box_mask_z=mask, ce_keep_lens=keep,
                                    weights=(w["giou"], w["l1"], w["focal"]), search_size=Tx,
                                    stride=stride, use_drop_path=True, seed=self.drop_seed)
        opt, sched = build_optimizer(model, lr=tr["lr"], weight_decay=tr["weight_decay"],
                                     grad_clip_norm=tr["grad_clip_norm"],
                                     trainable_mask=prompt_only_mask(model))
        self.state = TrainState(model, opt, sched)
        self.k = 0
        trained = {n: q for n, q in model.named_parameters() if q.requires_grad}
        losses, first_grad = [], None
        for _ in range(FIRST_STEPS):
            stats = self._step()
            losses.append(float(stats["Loss/total"]))
            if first_grad is None:
                first_grad = {n: opt.state[q]["exp_avg"].detach().clone() / (1 - BETA1)
                              for n, q in trained.items()}
        self.first = {"losses": losses, "first_grad": first_grad,
                      "delta": {n: q.detach().clone() - self.params[n]
                                for n, q in trained.items()}}

    def _step(self):
        b = self.batches[self.k % len(self.batches)]
        with torch.profiler.record_function("bench.train_step"):
            self.state, stats = self.step(self.state, b)
        self.k += 1
        return stats

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        self._sync()
        n = 0
        t0 = time.perf_counter()
        while True:
            self._step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        samples = n * self.p["batch"]
        return {"attempted": samples, "metrics": {"train_samples_per_s": samples / elapsed}}

    def traced_work(self, share: float = 1.0) -> dict:
        steps = max(1, round(self.p["trace"]["steps"] * share))
        for _ in range(steps):
            self._step()
        return {"attempted": steps * self.p["batch"], "steps": steps, "batch": self.p["batch"],
                "samples": steps * self.p["batch"]}

    def release(self) -> None:
        del self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, q=None) -> dict:
        c = self.p["check"]
        with ref.no_tf32():
            kw = {"band": c["tie_band"], "most": c["tied_rows"]} if q is None else {"q": q}
            out = ref.train_steps(self.params, self.cfg, self.batches[:FIRST_STEPS],
                                  self.drop_seed, **kw)
        out["delta"] = {k: v - self.params[k] for k, v in out["params"].items()}
        return out

    def check(self, control: bool = False) -> dict:
        r = self.reference()
        numbers, left_out, worst = compare.train_numbers(self.first, r)
        result = {"numbers": numbers, "compared": FIRST_STEPS * self.p["batch"],
                  "left_out": left_out, "worst_leaves": worst, "losses": self.first["losses"],
                  "ref_losses": r["losses"]}
        if control:
            low = self.reference(q=fp8)
            result["control"] = compare.train_numbers(low, r)[0]
        return result
