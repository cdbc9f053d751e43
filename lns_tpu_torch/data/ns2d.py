"""The NS2d corpora for stage-1 and stage-2 training (counterpart of
``lns_tpu.data.ns2d``; mirrors the reference's dataset/ns2d_fno_stage1.py
and dataset/ns2d_fno_stage2_simpleae.py).

One .npz with ``all_sol_center`` [T, H, W, Ncase]; the reference's 90/10
case split under numpy's global seed 1; a global scalar mean and a
per-frame-averaged std, cached at ``dataset_stat``. Frames are channels-last
[H, W, 1]; the corpus is kept as f32 numpy.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _split_indices(num_case: int, available: int) -> Tuple[np.ndarray, np.ndarray]:
    """Byte-identical to the reference split (ns2d_fno_stage1.py:23-38),
    global seed and all."""
    idxs = np.arange(min(num_case, available))
    np.random.seed(1)  # deterministic, matching the reference
    np.random.shuffle(idxs)
    cut = int(0.9 * len(idxs))
    return idxs[:cut], idxs[cut:]


class _NS2DBase:
    def __init__(self, cfg, train_mode: bool = True):
        self.cfg = cfg
        self.case_len = cfg.case_len
        self.train_mode = train_mode
        with np.load(cfg.data_dir, mmap_mode="r") as data:
            avail = data["all_sol_center"].shape[-1]
            train_idx, test_idx = _split_indices(cfg.num_case, avail)
            self.idxs = train_idx if train_mode else test_idx
            self.data = np.asarray(data["all_sol_center"][..., self.idxs], np.float32)
        self.stats = self._load_or_compute_stats(cfg.dataset_stat)

    def _load_or_compute_stats(self, stat_path: Optional[str]):
        if stat_path and os.path.exists(stat_path):
            stats = np.load(stat_path, allow_pickle=True)
            return {k: stats[k] for k in stats.files if k != "allow_pickle"}
        stats = {"mean": np.mean(self.data), "std": np.std(self.data, axis=0).mean()}
        if stat_path:
            np.savez(stat_path, **stats, allow_pickle=True)
        return stats

    @property
    def n_cases(self) -> int:
        return self.data.shape[-1]

    def normalize(self, u):
        return (u - float(self.stats["mean"])) / (float(self.stats["std"]) + 1e-8)

    def denormalize(self, x):
        """[..., H, W, C] -> physical units (ns2d_fno_stage1.py:106-114);
        numpy arrays and tensors alike."""
        return x * float(self.stats["std"]) + float(self.stats["mean"])


class NS2DStage1(_NS2DBase):
    """Stage 1: train batches are single normalised frames [b, H, W, 1];
    eval returns whole trajectories [n, T, H, W, 1]."""

    def __len__(self):
        if self.train_mode:
            return self.n_cases * self.case_len
        return self.n_cases

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        """Frames by index (case-major: index = case x case_len + t)."""
        case, t = indices // self.case_len, indices % self.case_len
        return self.normalize(self.data[t, :, :, case])[..., None].astype(np.float32)

    def eval_trajectories(self) -> np.ndarray:
        return self.normalize(np.moveaxis(self.data[: self.case_len], -1, 0))[..., None] \
            .astype(np.float32)


class NS2DStage2(_NS2DBase):
    """Stage 2: pre-encoded latent windows.

    Call ``encode_dataset(encode_fn, device)`` once before training (the
    reference's one-time pre-pass, train_stage2_ns2d.py:190-191); train
    batches are (z_in [b, 1, h, w, c], z_out [b, out_tw, h, w, c])."""

    def __init__(self, cfg, train_mode: bool = True):
        super().__init__(cfg, train_mode)
        self.in_tw = 1
        self.out_tw = cfg.out_tw
        self.interval = cfg.interval
        self.encoded: Optional[np.ndarray] = None

    @property
    def _windows_per_case(self) -> int:
        if (self.in_tw + self.out_tw) * self.interval == self.case_len:
            return 1
        return self.case_len - (self.in_tw + self.out_tw) * self.interval

    @property
    def _starts_per_case(self) -> int:
        # reference start_t modulo (ns2d_fno_stage2_simpleae.py:112)
        if (self.in_tw + self.out_tw) * self.interval == self.case_len:
            return 1
        return self.case_len // self.interval - (self.in_tw + self.out_tw)

    def __len__(self):
        if self.train_mode:
            return self.n_cases * self._windows_per_case
        return self.n_cases

    def encode_dataset(self, encode_fn: Callable, device, batch: int = 64):
        """Encode every frame once, `batch` frames per call (the last call
        padded with repeats of its last frame, so every call has one shape).
        encode_fn: [b, H, W, 1] -> [b, h, w, c], tensors on `device`. The
        corpus is kept as an f32 numpy array (a bf16 encode's values exactly)."""
        frames = np.moveaxis(self.data, -1, 0)  # [N, T, H, W]
        frames = self.normalize(frames)[..., None].astype(np.float32)
        flat = frames.reshape(-1, *frames.shape[2:])
        outs = []
        with torch.no_grad():
            for i in range(0, flat.shape[0], batch):
                chunk = flat[i: i + batch]
                pad = batch - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                z = encode_fn(torch.from_numpy(chunk).to(device))
                outs.append(z[: batch - pad] if pad else z)
            z = torch.cat(outs).float()
        z = z.reshape(self.n_cases, self.case_len, *z.shape[1:])
        z = z[:, : self.case_len: self.interval]  # temporal stride (:114)
        self.encoded = z.cpu().numpy()

    def get_batch(self, indices: np.ndarray):
        """Windows of the corpus by index: (z_in, z_out), numpy arrays."""
        if self.encoded is None:
            raise RuntimeError("call encode_dataset() first")
        wpc = self._windows_per_case
        case = indices // wpc
        start = indices % self._starts_per_case if wpc > 1 else np.zeros_like(indices)
        tw = self.in_tw + self.out_tw
        t_idx = start[:, None] + np.arange(tw)[None, :]
        z = self.encoded[case[:, None], t_idx]
        return z[:, : self.in_tw], z[:, self.in_tw:]

    def eval_trajectories(self):
        """(x0 [n, 1, H, W, 1], y [n, steps, H, W, 1]): normalised, strided
        (ns2d_fno_stage2_simpleae.py:116-138)."""
        traj = np.moveaxis(self.data[: self.case_len: self.interval], -1, 0)
        traj = self.normalize(traj)[..., None].astype(np.float32)
        return traj[:, : self.in_tw], traj[:, self.in_tw:]
