"""Kolmogorov-flow (KM2D) datasets (a copy of ``lns_tpu.data.km2d``; numpy
only, so ``encode_dataset`` takes a numpy -> numpy encode function).

Mirrors dataset/km2d_stage1.py / km2d_stage2.py (leftovers of removed
experiments in the reference — no trainer uses them, SURVEY.md section
2.11 — provided for library completeness): a single .npy of
[N, T, 256, 256] vorticity, spatially strided to `resolution`
(skip = 256 // resolution), first `train_num` sequences for training and
the last `test_num` for testing, global vort mean / per-time-std
normalization.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


class _KM2DBase:
    def __init__(self, cfg, train_mode: bool = True):
        self.cfg = cfg
        self.resolution = cfg.resolution
        self.skip = 256 // self.resolution
        self.case_len = cfg.case_len
        self.train_mode = train_mode
        total = cfg.train_num + cfg.test_num

        if train_mode:
            seq_no = list(range(cfg.train_num))
        else:
            seq_no = list(range(total - cfg.test_num, total))

        data = np.load(cfg.data_dir, mmap_mode="r")
        self.data = np.asarray(
            data[seq_no, : self.case_len, :: self.skip, :: self.skip], np.float32
        )
        del data

        if cfg.dataset_stat and os.path.exists(cfg.dataset_stat):
            stats = np.load(cfg.dataset_stat, allow_pickle=True)
            self.stats = {k: stats[k] for k in stats.files}
        else:
            self.stats = {
                "vort_mean": self.data.mean(),
                "vort_std": self.data.std(axis=1).mean(),
            }
            if cfg.dataset_stat:
                np.savez(cfg.dataset_stat, **self.stats)

    @property
    def n_cases(self):
        return self.data.shape[0]

    def normalize(self, u):
        return (u - float(self.stats["vort_mean"])) / float(self.stats["vort_std"])

    def denormalize(self, x):
        return x * float(self.stats["vort_std"]) + float(self.stats["vort_mean"])


class KM2DStage1(_KM2DBase):
    def __len__(self):
        if self.train_mode:
            return self.n_cases * self.case_len
        return self.n_cases

    def get_batch(self, indices: np.ndarray, rng: Optional[np.random.Generator] = None):
        """Train frames [b, H, W, 1]; the reference samples the time index
        uniformly at random per item (km2d_stage1.py:76) — pass `rng` for
        that behavior, else use the deterministic idx % case_len slot."""
        case = indices // self.case_len
        if rng is not None:
            t = rng.integers(0, self.case_len, size=len(indices))
        else:
            t = indices % self.case_len
        return self.normalize(self.data[case, t])[..., None].astype(np.float32)

    def eval_trajectories(self):
        return self.normalize(self.data)[..., None].astype(np.float32)


class KM2DStage2(_KM2DBase):
    def __init__(self, cfg, train_mode: bool = True):
        super().__init__(cfg, train_mode)
        self.out_tw = cfg.out_tw
        self.interval = cfg.interval
        self.encoded: Optional[np.ndarray] = None

    @property
    def _windows_per_case(self):
        return self.case_len - (self.out_tw + 1) * self.interval

    def __len__(self):
        if self.train_mode:
            return self.n_cases * self._windows_per_case
        return self.n_cases

    def encode_dataset(self, encode_fn: Callable, batch: int = 32):
        frames = self.normalize(self.data)[..., None].astype(np.float32)
        flat = frames.reshape(-1, *frames.shape[2:])
        outs = []
        for i in range(0, flat.shape[0], batch):
            chunk = flat[i : i + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            z = np.asarray(encode_fn(chunk))
            outs.append(z[: batch - pad] if pad else z)
        z = np.concatenate(outs, axis=0)
        self.encoded = z.reshape(self.n_cases, self.case_len, *z.shape[1:])

    def get_batch(self, indices: np.ndarray, rng: Optional[np.random.Generator] = None):
        assert self.encoded is not None, "call encode_dataset() first"
        case = indices // self._windows_per_case
        if rng is not None:
            start = rng.integers(0, self._windows_per_case, size=len(indices))
        else:
            start = indices % self._windows_per_case
        t_idx = start[:, None] + np.arange(self.out_tw + 1)[None] * self.interval
        z = self.encoded[case[:, None], t_idx]
        return z[:, :1], z[:, 1:]

    def eval_trajectories(self):
        traj = self.normalize(self.data)[..., None].astype(np.float32)
        x0 = traj[:, :1]
        y = traj[:, self.interval :: self.interval]
        return x0, y
