"""RGB training corpora of the OSTrack foundation training, a copy of
mmtrack_tpu/data/rgb_datasets.py (ViPT
lib/train/dataset/{lasot,got10k,trackingnet,coco_seq}.py and DeT's depth
twins).

The standard single-object-tracking mix is LaSOT + GOT-10k (the default
DATASETS_NAME ['LASOT', 'GOT10K_vottrain'] of the JAX config). Each dataset
implements the VideoDataset protocol (seq_info / get_frames) over its
on-disk layout; the RGB ones take an `image_loader`, which
data/lmdb_backend.py::wrap_dataset_with_lmdb points at an LMDB file (the
reference's *_lmdb twins). tests/test_torch_train_data.py holds every
reader against the JAX one.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from mmtrack_torch.data.composition import get_x_frame
from mmtrack_torch.data.datasets import DepthTrackTrain, VideoDataset
from mmtrack_torch.data.image_loader import default_image_loader


class LaSOT(VideoDataset):
    """LaSOT layout: root/<class>/<class>-<k>/img/*.jpg + groundtruth.txt +
    full_occlusion.txt + out_of_view.txt (lasot.py)."""

    name = "LASOT"

    def __init__(self, root: str, sequences: list[str] | None = None,
                 image_loader=default_image_loader):
        self.root = root
        self.loader = image_loader
        if sequences is None:
            sequences = []
            for cls in sorted(os.listdir(root)):
                cdir = os.path.join(root, cls)
                if os.path.isdir(cdir):
                    sequences += sorted(
                        f"{cls}/{s}" for s in os.listdir(cdir)
                        if os.path.isdir(os.path.join(cdir, s)))
        self.sequences = sequences
        self._cache: dict[int, dict] = {}

    def num_sequences(self):
        return len(self.sequences)

    def _seq_path(self, seq_id):
        return os.path.join(self.root, self.sequences[seq_id])

    def seq_info(self, seq_id):
        if seq_id not in self._cache:
            p = self._seq_path(seq_id)
            bbox = np.loadtxt(os.path.join(p, "groundtruth.txt"), delimiter=",")
            occ = np.loadtxt(os.path.join(p, "full_occlusion.txt"),
                             delimiter=",", dtype=np.int64)
            oov = np.loadtxt(os.path.join(p, "out_of_view.txt"),
                             delimiter=",", dtype=np.int64)
            valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
            visible = valid & (occ == 0) & (oov == 0)
            self._cache[seq_id] = {"bbox": bbox, "valid": valid, "visible": visible}
        return self._cache[seq_id]

    def get_frames(self, seq_id, frame_ids):
        p = os.path.join(self._seq_path(seq_id), "img")
        frames = [self.loader(os.path.join(p, f"{i + 1:08d}.jpg"))
                  for i in frame_ids]
        return frames, self.seq_info(seq_id)["bbox"][frame_ids].astype(np.float32)


class GOT10k(VideoDataset):
    """GOT-10k layout: root/<seq>/{*.jpg, groundtruth.txt, absence.label,
    cover.label}; split lists (vottrain/votval) are sequence-name files
    (got10k.py + data_specs/got10k_vot_*.txt)."""

    name = "GOT10K"

    def __init__(self, root: str, split_file: str | None = None,
                 image_loader=default_image_loader):
        self.root = root
        self.loader = image_loader
        if split_file and os.path.exists(split_file):
            with open(split_file) as f:
                self.sequences = [l.strip() for l in f if l.strip()]
        else:
            list_file = os.path.join(root, "list.txt")
            if os.path.exists(list_file):
                with open(list_file) as f:
                    self.sequences = [l.strip() for l in f if l.strip()]
            else:
                self.sequences = sorted(
                    s for s in os.listdir(root)
                    if os.path.isdir(os.path.join(root, s)))
        self._cache: dict[int, dict] = {}

    def num_sequences(self):
        return len(self.sequences)

    def seq_info(self, seq_id):
        if seq_id not in self._cache:
            p = os.path.join(self.root, self.sequences[seq_id])
            bbox = np.loadtxt(os.path.join(p, "groundtruth.txt"), delimiter=",")
            bbox = np.atleast_2d(bbox)
            absence = np.loadtxt(os.path.join(p, "absence.label"), dtype=np.int64) \
                if os.path.exists(os.path.join(p, "absence.label")) \
                else np.zeros(len(bbox), np.int64)
            cover = np.loadtxt(os.path.join(p, "cover.label"), dtype=np.int64) \
                if os.path.exists(os.path.join(p, "cover.label")) \
                else np.full(len(bbox), 8, np.int64)
            valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
            # reference: visible = ~absent & cover > 0 (got10k.py)
            visible = valid & (absence == 0) & (cover > 0)
            self._cache[seq_id] = {"bbox": bbox, "valid": valid, "visible": visible}
        return self._cache[seq_id]

    def get_frames(self, seq_id, frame_ids):
        p = os.path.join(self.root, self.sequences[seq_id])
        frames = [self.loader(os.path.join(p, f"{i + 1:08d}.jpg"))
                  for i in frame_ids]
        return frames, self.seq_info(seq_id)["bbox"][frame_ids].astype(np.float32)


class TrackingNet(VideoDataset):
    """TrackingNet layout: root/TRAIN_k/{frames/<seq>/<i>.jpg,
    anno/<seq>.txt} (trackingnet.py)."""

    name = "TRACKINGNET"

    def __init__(self, root: str, set_ids=range(12),
                 image_loader=default_image_loader):
        self.root = root
        self.loader = image_loader
        self.sequences = []  # (set_id, seq_name)
        for sid in set_ids:
            anno_dir = os.path.join(root, f"TRAIN_{sid}", "anno")
            if not os.path.isdir(anno_dir):
                continue
            for f in sorted(os.listdir(anno_dir)):
                if f.endswith(".txt"):
                    self.sequences.append((sid, f[:-4]))
        self._cache: dict[int, dict] = {}

    def num_sequences(self):
        return len(self.sequences)

    def seq_info(self, seq_id):
        if seq_id not in self._cache:
            sid, name = self.sequences[seq_id]
            bbox = np.loadtxt(os.path.join(self.root, f"TRAIN_{sid}", "anno",
                                           f"{name}.txt"), delimiter=",")
            bbox = np.atleast_2d(bbox)
            valid = (bbox[:, 2] > 0) & (bbox[:, 3] > 0)
            self._cache[seq_id] = {"bbox": bbox, "valid": valid, "visible": valid}
        return self._cache[seq_id]

    def get_frames(self, seq_id, frame_ids):
        sid, name = self.sequences[seq_id]
        p = os.path.join(self.root, f"TRAIN_{sid}", "frames", name)
        frames = [self.loader(os.path.join(p, f"{i}.jpg")) for i in frame_ids]
        return frames, self.seq_info(seq_id)["bbox"][frame_ids].astype(np.float32)


class COCOSeq(VideoDataset):
    """COCO instances as single-frame pseudo-videos (coco_seq.py); the
    sampler repeats the frame (sampler.py:146-149). Requires pycocotools."""

    name = "COCO17"
    is_video = False

    def __init__(self, root: str, split: str = "train2017",
                 image_loader=default_image_loader):
        try:
            from pycocotools.coco import COCO  # gated optional dep
        except ImportError as e:
            raise ImportError("COCOSeq requires pycocotools") from e
        self.root = root
        self.split = split
        self.loader = image_loader
        self.coco = COCO(os.path.join(root, "annotations",
                                      f"instances_{split}.json"))
        self.ann_ids = [a for a in self.coco.anns
                        if self.coco.anns[a]["area"] > 50
                        and not self.coco.anns[a].get("iscrowd", 0)]

    def num_sequences(self):
        return len(self.ann_ids)

    def seq_info(self, seq_id):
        ann = self.coco.anns[self.ann_ids[seq_id]]
        bbox = np.asarray([ann["bbox"]], np.float64)
        valid = np.asarray([bbox[0, 2] > 0 and bbox[0, 3] > 0])
        return {"bbox": bbox, "valid": valid, "visible": valid}

    def get_frames(self, seq_id, frame_ids):
        ann = self.coco.anns[self.ann_ids[seq_id]]
        img = self.coco.loadImgs([ann["image_id"]])[0]
        frame = self.loader(os.path.join(self.root, self.split, img["file_name"]))
        info = self.seq_info(seq_id)
        return [frame for _ in frame_ids], \
            np.tile(info["bbox"][0], (len(frame_ids), 1)).astype(np.float32)


class Got10kDepth(VideoDataset):
    """GOT-10k with estimated depth: root/<seq>/{color,depth} pairs,
    rgbcolormap composition with the DepthTrack clip
    (DeT/ltr/dataset/got10k_depth.py:164-177)."""

    name = "GOT10K_Depth"

    def __init__(self, root: str, sequences: list[str] | None = None,
                 dtype: str = "rgbcolormap"):
        self._inner = DepthTrackTrain(root, sequences)
        self._inner.dtype = dtype
        self._inner.depth_clip = True

    def num_sequences(self):
        return self._inner.num_sequences()

    def seq_info(self, seq_id):
        return self._inner.seq_info(seq_id)

    def get_frames(self, seq_id, frame_ids):
        return self._inner.get_frames(seq_id, frame_ids)


class LaSOTDepth(VideoDataset):
    """LaSOT with estimated depth (DeT/ltr/dataset/lasot_depth.py): class/
    sequence nesting with color/ + depth/ per sequence, groundtruth.txt,
    full_occlusion + out_of_view visibility."""

    name = "LASOT_Depth"

    def __init__(self, root: str, sequences: list[str] | None = None,
                 dtype: str = "rgbcolormap"):
        self.root = root
        self.dtype = dtype
        if sequences is None:
            sequences = []
            for cls in sorted(os.listdir(root)):
                cdir = os.path.join(root, cls)
                if not os.path.isdir(cdir):
                    continue
                if os.path.isdir(os.path.join(cdir, "color")):
                    sequences.append(cls)      # flat layout
                else:
                    sequences += [os.path.join(cls, s)
                                  for s in sorted(os.listdir(cdir))
                                  if os.path.isdir(os.path.join(cdir, s))]
        self.sequences = sequences
        self._cache: dict[int, dict] = {}
        self._frame_cache: dict[int, tuple] = {}

    def num_sequences(self):
        return len(self.sequences)

    def _seq_path(self, seq_id):
        return os.path.join(self.root, self.sequences[seq_id])

    def seq_info(self, seq_id):
        if seq_id not in self._cache:
            p = self._seq_path(seq_id)
            gt = np.atleast_2d(np.loadtxt(os.path.join(p, "groundtruth.txt"),
                                          delimiter=","))
            valid = (gt[:, 2] > 0) & (gt[:, 3] > 0)
            visible = valid.copy()
            occ_f = os.path.join(p, "full_occlusion.txt")
            oov_f = os.path.join(p, "out_of_view.txt")
            if os.path.exists(occ_f) and os.path.exists(oov_f):
                occ = np.loadtxt(occ_f, delimiter=",").reshape(-1).astype(bool)
                oov = np.loadtxt(oov_f, delimiter=",").reshape(-1).astype(bool)
                n = min(len(gt), len(occ), len(oov))
                visible = valid[:n] & ~occ[:n] & ~oov[:n]
                gt, valid = gt[:n], valid[:n]
            self._cache[seq_id] = {"bbox": gt, "valid": valid,
                                   "visible": visible}
        return self._cache[seq_id]

    def get_frames(self, seq_id, frame_ids):
        # frame lists are cached: get_frames is the sampler's hot path, and
        # a LaSOT directory holds thousands of frames
        if seq_id not in self._frame_cache:
            p = self._seq_path(seq_id)
            rgb = sorted(os.path.join(p, "color", f)
                         for f in os.listdir(os.path.join(p, "color")))
            dep = sorted(os.path.join(p, "depth", f)
                         for f in os.listdir(os.path.join(p, "depth")))
            self._frame_cache[seq_id] = (rgb, dep)
        rgb, dep = self._frame_cache[seq_id]
        frames = [get_x_frame(rgb[i], dep[i], self.dtype, depth_clip=True)
                  for i in frame_ids]
        boxes = self.seq_info(seq_id)["bbox"][frame_ids].astype(np.float32)
        return frames, boxes


class COCOSeqDepth(COCOSeq):
    """COCO instances with estimated depth: <split>/color/NAME.jpg +
    <split>/depth/NAME.png (DeT/ltr/dataset/coco_seq_depth.py:131-140)."""

    name = "COCO17_Depth"

    def __init__(self, root: str, split: str = "train2017",
                 dtype: str = "rgbcolormap"):
        super().__init__(root, split)
        self.dtype = dtype

    def get_frames(self, seq_id, frame_ids):
        ann = self.coco.anns[self.ann_ids[seq_id]]
        img = self.coco.loadImgs([ann["image_id"]])[0]
        color = os.path.join(self.root, self.split, "color", img["file_name"])
        depth = os.path.join(self.root, self.split, "depth",
                             os.path.splitext(img["file_name"])[0] + ".png")
        frame = get_x_frame(color, depth, self.dtype, depth_clip=True)
        info = self.seq_info(seq_id)
        return [frame for _ in frame_ids], \
            np.tile(info["bbox"][0], (len(frame_ids), 1)).astype(np.float32)


class ImageNetVID(VideoDataset):
    """ImageNet VID training videos (DeT/ltr/dataset/imagenetvid.py):
    ILSVRC layout Data/VID/train/<set>/<seq>/NNNNNN.JPEG with per-frame
    Annotations XML; one track per pseudo-sequence."""

    name = "IMAGENETVID"

    def __init__(self, root: str, image_loader=default_image_loader):
        self.root = root
        self.loader = image_loader
        data_dir = os.path.join(root, "Data", "VID", "train")
        # track enumeration parses every frame's XML of every sequence
        # (over 1M parses for VID's ~4k sequences of ~300 frames), so it is
        # kept in a json sidecar in the root (the reference's precomputed
        # sequence lists), in memory only when the root is read-only
        cache_path = os.path.join(root, ".mmtrack_vid_tracks.json")
        track_cache: dict[str, list] = {}
        if os.path.exists(cache_path):
            try:
                with open(cache_path) as f:
                    track_cache = json.load(f)
            except (OSError, ValueError):
                track_cache = {}
        cache_dirty = False
        self._seqs = []  # (frames_dir, anno_dir, track_id)
        for set_name in sorted(os.listdir(data_dir)):
            sdir = os.path.join(data_dir, set_name)
            if not os.path.isdir(sdir):
                continue
            for seq in sorted(os.listdir(sdir)):
                anno_dir = os.path.join(root, "Annotations", "VID", "train",
                                        set_name, seq)
                if not os.path.isdir(anno_dir):
                    continue
                key = f"{set_name}/{seq}"
                tracks = track_cache.get(key)
                if tracks is None:
                    tracks = self._track_ids(anno_dir)
                    track_cache[key] = tracks
                    cache_dirty = True
                for t in tracks:
                    self._seqs.append((os.path.join(sdir, seq), anno_dir, t))
        if cache_dirty:
            try:
                tmp = cache_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(track_cache, f)
                os.replace(tmp, cache_path)
            except OSError:
                pass  # read-only dataset root: enumeration stays per-run
        self._cache: dict[int, dict] = {}

    def _track_ids(self, anno_dir):
        # scan EVERY frame's XML: VID objects routinely enter mid-sequence,
        # so the first frame alone under-enumerates the tracks
        # (DeT ltr/dataset/imagenetvid.py builds tracks across all frames)
        ids: set = set()
        for f in sorted(os.listdir(anno_dir)):
            tree = ET.parse(os.path.join(anno_dir, f))
            ids.update(obj.findtext("trackid")
                       for obj in tree.getroot().iter("object"))
        return sorted(ids)

    def num_sequences(self):
        return len(self._seqs)

    def _parse(self, seq_id):
        frames_dir, anno_dir, track = self._seqs[seq_id]
        names, boxes, vis = [], [], []
        for f in sorted(os.listdir(anno_dir)):
            tree = ET.parse(os.path.join(anno_dir, f))
            root = tree.getroot()
            found = None
            occluded = False
            for obj in root.iter("object"):
                if obj.findtext("trackid") == track:
                    bb = obj.find("bndbox")
                    x1 = float(bb.findtext("xmin")); y1 = float(bb.findtext("ymin"))
                    x2 = float(bb.findtext("xmax")); y2 = float(bb.findtext("ymax"))
                    found = [x1, y1, x2 - x1, y2 - y1]
                    occluded = obj.findtext("occluded") == "1"
                    break
            names.append(os.path.splitext(f)[0] + ".JPEG")
            boxes.append(found if found else [0, 0, 0, 0])
            vis.append(found is not None and not occluded)
        return {"frames": [os.path.join(frames_dir, n) for n in names],
                "bbox": np.asarray(boxes, np.float64),
                "visible": np.asarray(vis, bool)}

    def seq_info(self, seq_id):
        if seq_id not in self._cache:
            d = self._parse(seq_id)
            valid = (d["bbox"][:, 2] > 0) & (d["bbox"][:, 3] > 0)
            self._cache[seq_id] = {"bbox": d["bbox"], "valid": valid,
                                   "visible": d["visible"] & valid,
                                   "frames": d["frames"]}
        return self._cache[seq_id]

    def get_frames(self, seq_id, frame_ids):
        info = self.seq_info(seq_id)
        frames = [self.loader(info["frames"][i]) for i in frame_ids]
        return frames, info["bbox"][frame_ids].astype(np.float32)
