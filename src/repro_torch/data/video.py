"""Synthetic video streams with exact ground truth.

Mirrors the paper's video characteristics (§2.2):
  * a fraction of frames has no moving objects (§2.2.1: one-third to one-half)
  * each stream draws from a limited, stream-specific subset of the global
    class space, with power-law frequencies (§2.2.2: 3-10% of classes cover
    >=95% of objects)
  * objects persist across frames with slowly drifting appearance
    (§2.2.3: duplicate objects with nearly identical features)

Objects are procedurally rendered: each class has a distinct low-frequency
color pattern + oriented grating; instances jitter around the class
prototype; per-frame drift is small. This is learnable by the cheap CNN
family and gives exact generator labels to score the GT-CNN against.

Access path: ``object_stream()`` / ``objects_array()`` — post-detection
object crops (the paper's metrics count only GPU classification time).
Full frames for background subtraction come with that slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional

import numpy as np


@dataclass(frozen=True)
class StreamConfig:
    name: str
    seed: int = 0
    n_classes: int = 1000          # GT label space (ImageNet-like)
    n_stream_classes: int = 12     # classes that actually occur here
    zipf_a: float = 1.6            # class-frequency skew
    fps: int = 30
    duration_s: int = 120
    frame_res: int = 128
    obj_res: int = 32
    mean_tracks_per_frame: float = 1.2
    frac_empty: float = 0.4        # frames with no moving object
    dwell_s: float = 1.5           # seconds an object stays in view
    appearance_jitter: float = 0.12
    drift: float = 0.02

    @property
    def n_frames(self) -> int:
        return self.fps * self.duration_s


class DetectedObject(NamedTuple):
    frame_id: int
    track_id: int
    crop: np.ndarray          # (obj_res, obj_res, 3) float32 in [0, 1]
    true_class: int           # generator label (global class id)


class Track(NamedTuple):
    track_id: int
    cls: int
    t0: int
    t1: int
    proto: np.ndarray
    x0: float
    y0: float
    vx: float
    vy: float


def _class_proto(cls: int, res: int) -> np.ndarray:
    """Deterministic prototype pattern for a class."""
    rng = np.random.default_rng(cls * 7919 + 13)
    palette = rng.uniform(0.1, 0.9, size=(4, 4, 3))
    base = np.kron(palette, np.ones((res // 4, res // 4, 1)))
    yy, xx = np.mgrid[0:res, 0:res] / res
    theta = (cls % 17) / 17.0 * np.pi
    freq = 3 + (cls % 5)
    grating = 0.25 * np.sin(2 * np.pi * freq *
                            (xx * np.cos(theta) + yy * np.sin(theta)))
    return np.clip(base + grating[..., None], 0.0, 1.0).astype(np.float32)


class VideoStream:
    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # Stream-specific class subset with zipf frequencies (§2.2.2)
        all_classes = np.arange(cfg.n_classes)
        self.rng.shuffle(all_classes)
        self.stream_classes = np.sort(all_classes[: cfg.n_stream_classes])
        w = 1.0 / np.arange(1, cfg.n_stream_classes + 1) ** cfg.zipf_a
        self.class_probs = w / w.sum()
        self._tracks = self._make_tracks()

    def _make_tracks(self) -> List[Track]:
        cfg = self.cfg
        dwell = max(1, int(cfg.dwell_s * cfg.fps))
        # expected live tracks per frame; thin births so ~frac_empty frames
        # see no object at all
        n_frames = cfg.n_frames
        target_births = cfg.mean_tracks_per_frame * n_frames / dwell
        births = self.rng.poisson(target_births / n_frames, size=n_frames)
        # carve out empty stretches
        empty = self.rng.random(n_frames) < cfg.frac_empty
        births[empty] = 0
        tracks = []
        tid = 0
        for t, b in enumerate(births):
            for _ in range(int(b)):
                cls_local = self.rng.choice(len(self.stream_classes),
                                            p=self.class_probs)
                cls = int(self.stream_classes[cls_local])
                proto = _class_proto(cls, cfg.obj_res)
                inst = proto + self.rng.normal(
                    0, cfg.appearance_jitter, proto.shape).astype(np.float32)
                d = int(dwell * self.rng.uniform(0.5, 1.5))
                x0, y0 = self.rng.uniform(0.05, 0.6, size=2)
                vx, vy = self.rng.uniform(-0.3, 0.3, size=2) / cfg.fps
                tracks.append(Track(tid, cls, t, min(t + d, n_frames),
                                    np.clip(inst, 0, 1), x0, y0, vx, vy))
                tid += 1
        return tracks

    # -- fast path: post-detection object crops --------------------------------

    def object_stream(self, max_frames: Optional[int] = None,
                      frame_stride: int = 1) -> Iterator[DetectedObject]:
        """Yields one DetectedObject per (visible track, sampled frame)."""
        cfg = self.cfg
        n = min(cfg.n_frames, max_frames or cfg.n_frames)
        rng = np.random.default_rng(cfg.seed + 1)
        by_frame: List[List[Track]] = [[] for _ in range(n)]
        for tr in self._tracks:
            for t in range(tr.t0, min(tr.t1, n)):
                by_frame[t].append(tr)
        for t in range(0, n, frame_stride):
            for tr in by_frame[t]:
                drift = rng.normal(0, cfg.drift, tr.proto.shape)
                crop = np.clip(tr.proto + drift, 0, 1).astype(np.float32)
                yield DetectedObject(t, tr.track_id, crop, tr.cls)

    def objects_array(self, max_frames: Optional[int] = None,
                      frame_stride: int = 1):
        """Materialize the stream: (crops (N,R,R,3), frames (N,), tracks (N,),
        labels (N,))."""
        objs = list(self.object_stream(max_frames, frame_stride))
        if not objs:
            r = self.cfg.obj_res
            return (np.zeros((0, r, r, 3), np.float32),
                    np.zeros((0,), np.int64), np.zeros((0,), np.int64),
                    np.zeros((0,), np.int64))
        crops = np.stack([o.crop for o in objs])
        frames = np.array([o.frame_id for o in objs])
        tracks = np.array([o.track_id for o in objs])
        labels = np.array([o.true_class for o in objs])
        return crops, frames, tracks, labels


# The 13-stream zoo used in benchmarks (traffic / surveillance / news mix,
# mirroring Table 1's busy/normal/rotating/plaza/news variety via different
# class counts, skews and empty fractions).
STREAM_ZOO = [
    StreamConfig("auburn_c", seed=1, n_stream_classes=16, zipf_a=1.3,
                 mean_tracks_per_frame=2.5, frac_empty=0.3),
    StreamConfig("auburn_r", seed=2, n_stream_classes=8, zipf_a=1.9,
                 mean_tracks_per_frame=0.8, frac_empty=0.5),
    StreamConfig("city_a_d", seed=3, n_stream_classes=18, zipf_a=1.3,
                 mean_tracks_per_frame=2.8, frac_empty=0.25),
    StreamConfig("city_a_r", seed=4, n_stream_classes=9, zipf_a=1.8,
                 mean_tracks_per_frame=1.0, frac_empty=0.45),
    StreamConfig("bend", seed=5, n_stream_classes=7, zipf_a=2.0,
                 mean_tracks_per_frame=0.7, frac_empty=0.5),
    StreamConfig("jacksonh", seed=6, n_stream_classes=20, zipf_a=1.2,
                 mean_tracks_per_frame=3.0, frac_empty=0.2),
    StreamConfig("church_st", seed=7, n_stream_classes=14, zipf_a=1.5,
                 mean_tracks_per_frame=1.6, frac_empty=0.35, dwell_s=0.8),
    StreamConfig("lausanne", seed=8, n_stream_classes=8, zipf_a=1.8,
                 mean_tracks_per_frame=1.2, frac_empty=0.4),
    StreamConfig("oxford", seed=9, n_stream_classes=9, zipf_a=1.7,
                 mean_tracks_per_frame=1.0, frac_empty=0.45),
    StreamConfig("sittard", seed=10, n_stream_classes=11, zipf_a=1.6,
                 mean_tracks_per_frame=1.4, frac_empty=0.4),
    StreamConfig("cnn", seed=11, n_stream_classes=24, zipf_a=1.1,
                 mean_tracks_per_frame=2.2, frac_empty=0.2, dwell_s=2.5),
    StreamConfig("foxnews", seed=12, n_stream_classes=22, zipf_a=1.15,
                 mean_tracks_per_frame=2.0, frac_empty=0.2, dwell_s=2.5),
    StreamConfig("msnbc", seed=13, n_stream_classes=26, zipf_a=1.1,
                 mean_tracks_per_frame=2.4, frac_empty=0.2, dwell_s=2.5),
]


def get_stream(name: str, **overrides) -> VideoStream:
    for s in STREAM_ZOO:
        if s.name == name:
            return VideoStream(dataclasses.replace(s, **overrides))
    raise KeyError(name)


def gt_oracle(labels_all: np.ndarray):
    """GT-CNN oracle over crops (exact; keyed by nearest class prototype)."""
    protos = {int(c): None for c in np.unique(labels_all)}

    def gt_apply(crops):
        out = np.empty(len(crops), np.int64)
        for i, c in enumerate(crops):
            best, bd = -1, 1e18
            for cls in protos:
                if protos[cls] is None:
                    protos[cls] = _class_proto(cls, c.shape[0])
                d = float(np.abs(c - protos[cls]).mean())
                if d < bd:
                    best, bd = cls, d
            out[i] = best
        return out

    return gt_apply
