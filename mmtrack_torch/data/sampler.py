"""TrackingSampler: dataset-weighted frame-pair sampling, port of
mmtrack_tpu/data/sampler.py (:17-175; ViPT lib/train/data/sampler.py:12-170
and :298-345): the causal mode, and the `trident`, `trident_pro` and
`stark` modes of the STARK / MixFormer lineage (an initial template and a
search anywhere, then one extra template per `max_gap` entry from the
window between them; `trident_pro` allows invisible extras, `stark`
draws them from the sequence's `valid` flags). Draws come from one
np.random.Generator in the JAX package's order, so the same seed gives the
same samples."""

from __future__ import annotations

import numpy as np

from mmtrack_torch.data.datasets import VideoDataset


class TrackingSampler:
    def __init__(self, datasets: list[VideoDataset], p_datasets: list[float] | None,
                 samples_per_epoch: int, max_gap, num_search_frames: int = 1,
                 num_template_frames: int = 1, processing=None,
                 frame_sample_mode: str = "causal", seed: int = 0):
        if frame_sample_mode not in ("causal", "trident", "trident_pro", "stark"):
            raise ValueError(f"frame_sample_mode={frame_sample_mode!r}")
        self.datasets = datasets
        if p_datasets is None:
            p_datasets = [len(d) for d in datasets]
        total = float(sum(p_datasets))
        self.p_datasets = [p / total for p in p_datasets]
        self.samples_per_epoch = samples_per_epoch
        self.max_gap = max_gap
        self.num_search_frames = num_search_frames
        self.num_template_frames = num_template_frames
        self.processing = processing
        self.frame_sample_mode = frame_sample_mode
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.samples_per_epoch

    def _sample_visible_ids(self, visible: np.ndarray, num_ids: int = 1, min_id=None,
                            max_id=None, allow_invisible: bool = False):
        if num_ids == 0:
            return []
        lo = 0 if min_id is None or min_id < 0 else int(min_id)
        hi = len(visible) if max_id is None or max_id > len(visible) else int(max_id)
        if hi <= lo:
            return None
        valid = np.arange(lo, hi) if allow_invisible else np.nonzero(visible[lo:hi])[0] + lo
        if valid.size == 0:
            return None
        return list(self.rng.choice(valid, size=num_ids, replace=True))

    def _sample_seq(self, dataset: VideoDataset):
        """A random sequence with more than 2 * (search + template) visible
        frames and at least 20 frames (sampler.py:273); waived for
        non-video datasets."""
        need = 2 * (self.num_search_frames + self.num_template_frames)
        for _ in range(1000):
            seq_id = int(self.rng.integers(0, dataset.num_sequences()))
            info = dataset.seq_info(seq_id)
            visible = info["visible"]
            if (visible.sum() > need and len(visible) >= 20) or not dataset.is_video:
                return seq_id, visible, info
        raise RuntimeError(f"no usable sequence found in {dataset.name}")

    def _causal_ids(self, visible: np.ndarray):
        """Template frame(s), then later search frame(s) in a window that
        grows by 5 after every miss (sampler.py:123-139)."""
        template_ids = search_ids = None
        gap = 0
        while search_ids is None:
            base = self._sample_visible_ids(visible, 1, self.num_template_frames - 1,
                                            len(visible) - self.num_search_frames)
            if base is None:
                return None, None
            prev = self._sample_visible_ids(visible, self.num_template_frames - 1,
                                            base[0] - self.max_gap - gap, base[0])
            if prev is None:
                gap += 5
                continue
            template_ids = base + prev
            search_ids = self._sample_visible_ids(visible, self.num_search_frames,
                                                  template_ids[0] + 1,
                                                  template_ids[0] + self.max_gap + gap)
            if search_ids is not None and self.num_search_frames > 1:
                search_ids = sorted(search_ids)
            gap += 5
            if gap > 100 * self.max_gap:
                return None, None
        return template_ids, search_ids

    def _trident_ids(self, visible: np.ndarray, allow_invisible: bool,
                     valid: np.ndarray | None = None):
        """The trident modes (sampler.py:298-345): a template and a search
        frame anywhere, then per `max_gap` entry one extra template from the
        window of that width on the template's side of the search frame,
        from `valid` where given; 100 tries."""
        extra_pool = visible if valid is None else valid
        gaps = list(self.max_gap) if isinstance(self.max_gap, (list, tuple)) else [self.max_gap]
        for _ in range(100):
            t1 = self._sample_visible_ids(visible, 1)
            s = self._sample_visible_ids(visible, 1)
            if t1 is None or s is None:
                return None, None
            extras = []
            for gap in gaps:
                lo, hi = (s[0], s[0] + gap) if t1[0] >= s[0] else (s[0] - gap, s[0])
                f = self._sample_visible_ids(extra_pool, 1, lo, hi,
                                             allow_invisible=allow_invisible)
                if f is None:
                    break
                extras += f
            else:
                return t1 + extras, s
        return None, None

    def _frame_ids(self, visible: np.ndarray, info: dict):
        mode = self.frame_sample_mode
        if mode in ("trident", "trident_pro"):
            return self._trident_ids(visible, mode == "trident_pro")
        if mode == "stark":
            return self._trident_ids(visible, False, info.get("valid", visible))
        return self._causal_ids(visible)

    def sample(self) -> dict:
        """One processed training sample; invalid samples are redrawn."""
        while True:
            dataset = self.datasets[int(self.rng.choice(len(self.datasets),
                                                        p=self.p_datasets))]
            seq_id, visible, info = self._sample_seq(dataset)
            if dataset.is_video:
                template_ids, search_ids = self._frame_ids(visible, info)
                if template_ids is None:
                    continue
            else:
                template_ids = [0] * self.num_template_frames
                search_ids = [0] * self.num_search_frames
            try:
                t_frames, t_boxes = dataset.get_frames(seq_id, template_ids)
                s_frames, s_boxes = dataset.get_frames(seq_id, search_ids)
                data = {"template_images": t_frames, "template_anno": t_boxes,
                        "search_images": s_frames, "search_anno": s_boxes,
                        "dataset": dataset.name}
                if self.processing is not None:
                    # a jittered crop can fall outside the image and raise in
                    # cv2: the reference's retry wraps processing too
                    data = self.processing(data, self.rng)
                    if not data.get("valid", False):
                        continue
            except Exception:
                continue
            return data
