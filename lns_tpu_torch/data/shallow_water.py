"""PDEArena shallow-water datasets (zarr stores, u/v/pres variables), the
counterpart of ``lns_tpu.data.shallow_water``.

Mirrors dataset/Stage1_SW.py and dataset/Stage2_SW.py: separate train/test
stores, per-channel mean/std from a precomputed ``normstats.pt``,
start_frame=2 skip, interval=2 temporal stride for stage 2.

Storage: zarr v2 directories (via the minimal reader, ``data.zarr_reader``)
or an .npz with keys u, v, pres [N, T, H, W]. Norm stats: torch .pt (dict of
{'u': {'mean','std'}, ...}) or .npz with u_mean/u_std/... keys.

Channels-last frames: [H, W, 3] = (u, v, pres); the corpus is kept as f32
numpy.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from lns_tpu_torch.data.loader import scale_shift
from lns_tpu_torch.data.zarr_reader import open_zarr

CHANNELS = ("u", "v", "pres")


def _load_uvp(path: str, num_case: int):
    if path.endswith(".npz"):
        d = np.load(path)
        u, v, p = d["u"], d["v"], d["pres"]
    else:
        g = open_zarr(path)
        u, v, p = g["u"].read_all(), g["v"].read_all(), g["pres"].read_all()
    u = np.asarray(u, np.float32)[:num_case]
    v = np.asarray(v, np.float32)[:num_case]
    p = np.asarray(p, np.float32)[:num_case]
    # PDEArena stores u/v as [N, T, 1, H, W] and pres as [N, T, H, W]
    if u.ndim == 5:
        u, v = u[:, :, 0], v[:, :, 0]
    return u, v, p


def _load_normstats(path: str):
    if path.endswith(".npz"):
        d = np.load(path)
        return {ch: {"mean": float(d[f"{ch}_mean"]), "std": float(d[f"{ch}_std"])}
                for ch in CHANNELS}
    raw = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for ch in CHANNELS:
        m, s = raw[ch]["mean"], raw[ch]["std"]
        out[ch] = {"mean": float(np.asarray(m).reshape(-1)[0]),
                   "std": float(np.asarray(s).reshape(-1)[0])}
    return out


class _SWBase:
    def __init__(self, cfg, train_mode: bool = True):
        self.cfg = cfg
        self.case_len = cfg.case_len
        self.train_mode = train_mode
        self.start_frame = 2  # skip the first frames (Stage1_SW.py:39)

        path = cfg.train_data_dir if train_mode else cfg.test_data_dir
        num_case = cfg.num_case if train_mode else 10**9
        u, v, p = _load_uvp(path, num_case)
        self.num_case = u.shape[0]
        self.fields = np.stack([u, v, p], axis=-1)  # [N, T, H, W, 3]
        self.normstat = _load_normstats(cfg.dataset_stat)

    def normalize(self, x):
        out = np.empty_like(x)
        for i, ch in enumerate(CHANNELS):
            out[..., i] = (x[..., i] - self.normstat[ch]["mean"]) / self.normstat[ch]["std"]
        return out

    def denormalize(self, x):
        """[..., 3] -> physical units, channel by channel (numpy arrays and
        tensors alike, in their dtype; a tensor's scalars in its dtype, as
        JAX rounds a weakly typed scalar to a bf16 array's dtype)."""
        chans = [scale_shift(x[..., i: i + 1], self.normstat[ch]["std"], self.normstat[ch]["mean"])
                 for i, ch in enumerate(CHANNELS)]
        if isinstance(x, torch.Tensor):
            return torch.cat(chans, dim=-1)
        return np.concatenate(chans, axis=-1)


class SWStage1(_SWBase):
    """Stage 1: train batches are single normalised frames [b, H, W, 3]
    (frames from ``start_frame`` on); eval returns whole trajectories."""

    def __len__(self):
        if self.train_mode:
            return self.num_case * (self.case_len - self.start_frame)
        return self.num_case

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        per = self.case_len - self.start_frame
        case = indices // per
        t = indices % per + self.start_frame
        return self.normalize(self.fields[case, t])

    def eval_trajectories(self) -> np.ndarray:
        return self.normalize(self.fields[:, self.start_frame:])


class SWStage2(_SWBase):
    """Stage 2: pre-encoded latent windows, ``interval`` 2 as the reference
    hard-codes it (Stage2_SW.py:35-36); the reference's window-sampling
    quirk is opt-in (``cfg.window_quirk``).

    Call ``encode_dataset(encode_fn, device)`` once before training; train
    batches are (z_in [b, 1, h, w, c], z_out [b, out_tw, h, w, c])."""

    def __init__(self, cfg, train_mode: bool = True):
        super().__init__(cfg, train_mode)
        self.in_tw = 1
        self.interval = 2  # hard-coded in the reference (Stage2_SW.py:35-36)
        self.out_tw = cfg.out_tw
        self.encoded: Optional[np.ndarray] = None

    @property
    def _span(self) -> int:
        return (self.in_tw + self.out_tw) * self.interval + self.start_frame

    @property
    def _full_window(self) -> bool:
        return self._span == self.case_len

    def __len__(self):
        if self.train_mode:
            if self._full_window:
                return self.num_case
            return self.num_case * (self.case_len - self._span)
        return self.num_case

    def encode_dataset(self, encode_fn: Callable, device, batch: int = 32):
        """Encode every frame once, `batch` frames per call (the last call
        padded with repeats of its last frame, so every call has one shape).
        encode_fn: [b, H, W, 3] -> [b, h, w, c], tensors on `device`. The
        corpus is kept as an f32 numpy array (a bf16 encode's values
        exactly)."""
        frames = self.normalize(self.fields)
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
            z = torch.cat(outs).float().cpu().numpy()
        self.encoded = z.reshape(self.num_case, self.case_len, *z.shape[1:])

    def _cases(self, indices):
        if self._full_window:
            return indices
        return indices // (self.case_len - self._span)

    def _start(self, indices):
        if self._full_window:
            return np.zeros_like(indices) + self.start_frame
        # the reference's modulo takes the wrong denominator, which limits SW
        # stage-2 windows to early frames (Stage2_SW.py:125); opt-in
        denom = self._span if self.cfg.window_quirk else self.case_len - self._span
        return self.start_frame + indices % denom

    def _times(self, indices):
        start, iv = self._start(indices), self.interval
        t_in = start[:, None] + np.arange(0, self.in_tw * iv, iv)[None]
        t_out = start[:, None] + self.in_tw * iv + np.arange(0, self.out_tw * iv, iv)[None]
        return t_in, t_out

    def get_batch(self, indices: np.ndarray):
        """Windows of the corpus by index: (z_in, z_out), numpy arrays."""
        if self.encoded is None:
            raise RuntimeError("call encode_dataset() first")
        case = self._cases(indices)[:, None]
        t_in, t_out = self._times(indices)
        return self.encoded[case, t_in], self.encoded[case, t_out]

    def eval_trajectories(self):
        """(x0 [n, 1, H, W, 3], y [n, steps, H, W, 3]): normalised, strided."""
        traj = self.normalize(self.fields[:, self.start_frame:: self.interval])
        return traj[:, : self.in_tw], traj[:, self.in_tw:]

    def get_pixel_batch(self, indices: np.ndarray):
        """Pixel-space windows (x_in, x_out): the reference's SW2DDataSimple
        (Stage2_SW.py:152-275), the same windows with fields in place of
        latents."""
        case = self._cases(indices)[:, None]
        t_in, t_out = self._times(indices)
        frames = self.normalize(self.fields)
        return frames[case, t_in], frames[case, t_out]


class SW2DDataSimple(SWStage2):
    """Pixel-space stage-2 twin: batches come from ``get_pixel_batch`` (no
    encode pre-pass needed)."""

    def get_batch(self, indices: np.ndarray):
        return self.get_pixel_batch(indices)
