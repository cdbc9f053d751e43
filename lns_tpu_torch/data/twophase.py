"""Two-phase tank-sloshing datasets (a directory of per-case .npz), the
counterpart of ``lns_tpu.data.twophase``.

Mirrors dataset/twophase_flow_stage1.py and twophase_flow_stage2.py: per
case vel [T, H, W, 2], prs [T, H, W], vof [T, H, W] and, for the conditional
family, a scalar ``freq`` (the case's driving frequency, the propagator's
conditioning parameter); rows clipped to 61; the seed-44 90/10 case split;
global mean/std normalisation of vel and prs, vof left in [0, 1], the
parameter scaled to [0, 1] over its range widened by 2 on each side
(twophase_flow_stage2.py:296-297); ``denormalize`` re-imposes the Dirichlet
walls (zero velocity on all four borders) and clamps vof
(twophase_flow_stage1.py:148-169).

Channels-last frames: [H, W, 4] = (vx, vy, prs, vof); the corpus is kept
as f32 numpy.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lns_tpu_torch.data.loader import scale_shift


def _split_indices(num_case: int, available: int):
    """The reference's split (global numpy seed 44, 90 % for training)."""
    idxs = np.arange(min(num_case, available))
    np.random.seed(44)  # deterministic, matching the reference
    np.random.shuffle(idxs)
    cut = int(0.9 * len(idxs))
    return idxs[:cut], idxs[cut:]


class _TankBase:
    conditional = False  # whether each case carries its `freq`

    def __init__(self, cfg, train_mode: bool = True):
        self.cfg = cfg
        self.case_len = cfg.case_len
        self.train_mode = train_mode

        f_lst = sorted(f for f in os.listdir(cfg.data_dir) if f.endswith(".npz"))
        train_idx, test_idx = _split_indices(cfg.num_case, len(f_lst))
        self.idxs = train_idx if train_mode else test_idx

        fields, params = [], []
        for i in self.idxs:
            d = np.load(os.path.join(cfg.data_dir, f_lst[i]))
            vel, prs, vof = d["vel"], d["prs"], d["vof"]
            if vel.shape[1] > 61:
                vel, prs, vof = vel[:, :61], prs[:, :61], vof[:, :61]
            assert self.case_len <= vel.shape[0]
            x = np.concatenate([vel, prs[..., None], vof[..., None]], axis=-1)
            fields.append(x[: self.case_len].astype(np.float32))
            if self.conditional:
                params.append(float(d["freq"]))
        # [N, T, H, W, 4]: the whole corpus in memory, as the reference keeps it
        self.fields = np.stack(fields, axis=0)
        self.params_raw = np.asarray(params, np.float32) if self.conditional else None
        self.stats = self._load_or_compute_stats(cfg.dataset_stat)

    def _compute_stats(self) -> Dict[str, np.ndarray]:
        vel = self.fields[..., :2]
        prs = self.fields[..., 2]
        stats = {"vel_mean": np.mean(vel), "vel_std": np.std(vel),
                 "prs_mean": np.mean(prs), "prs_std": np.std(prs),
                 "height": self.fields.shape[2], "width": self.fields.shape[3]}
        if self.conditional:
            stats.update(self._param_range())
        return stats

    def _param_range(self) -> Dict[str, np.ndarray]:
        """The parameter's range widened by 2 on each side
        (twophase_flow_stage2.py:296-297)."""
        return {"param_min": np.min(self.params_raw) - 2.0,
                "param_max": np.max(self.params_raw) + 2.0}

    def _load_or_compute_stats(self, stat_path):
        if stat_path and os.path.exists(stat_path):
            stats = np.load(stat_path, allow_pickle=True)
            out = {k: stats[k] for k in stats.files if k != "allow_pickle"}
            if self.conditional and "param_min" not in out:
                # a stats file without the range (a stage-1 run wrote it):
                # the range of these cases is added, the file left as it is
                out.update(self._param_range())
            return out
        stats = self._compute_stats()
        if stat_path:
            np.savez(stat_path, **stats, allow_pickle=True)
        return stats

    @property
    def n_cases(self):
        return self.fields.shape[0]

    def normalize(self, x):
        """[..., H, W, 4] raw -> normalised (vof untouched); numpy."""
        out = np.empty_like(x)
        out[..., :2] = (x[..., :2] - float(self.stats["vel_mean"])) / float(self.stats["vel_std"])
        out[..., 2] = (x[..., 2] - float(self.stats["prs_mean"])) / float(self.stats["prs_std"])
        out[..., 3] = x[..., 3]
        return out

    def normalize_param(self, p):
        """The raw parameter -> [0, 1] over the widened range."""
        lo, hi = float(self.stats["param_min"]), float(self.stats["param_max"])
        return (p - lo) / (hi - lo)

    def denormalize(self, x):
        """[..., H, W, 4] -> physical units, zero velocity on the four walls,
        vof clamped to [0, 1 + 1e-8] (numpy arrays and tensors alike; the
        wall mask is f32, so a bf16 velocity comes out in f32 and the rest
        follows the concatenation's promotion, as the JAX package's does)."""
        h, w = x.shape[-3], x.shape[-2]
        mask = np.ones((h, w, 1), np.float32)
        mask[0, :] = mask[-1, :] = 0.0
        mask[:, 0] = mask[:, -1] = 0.0
        vel = scale_shift(x[..., :2], self.stats["vel_std"], self.stats["vel_mean"])
        prs = scale_shift(x[..., 2:3], self.stats["prs_std"], self.stats["prs_mean"])
        if isinstance(x, torch.Tensor):
            vel = vel * torch.from_numpy(mask).to(x.device)
            return torch.cat([vel, prs, x[..., 3:4].clamp(0.0, 1.0 + 1e-8)], dim=-1)
        return np.concatenate([vel * mask, prs, np.clip(x[..., 3:4], 0.0, 1.0 + 1e-8)], axis=-1)


class TankSloshingStage1(_TankBase):
    """Stage 1: train batches are single normalised frames [b, H, W, 4];
    eval returns whole trajectories."""

    def __len__(self):
        if self.train_mode:
            return self.n_cases * self.case_len
        return self.n_cases

    def get_batch(self, indices: np.ndarray) -> np.ndarray:
        case = indices // self.case_len
        t = indices % self.case_len
        return self.normalize(self.fields[case, t])

    def eval_trajectories(self) -> np.ndarray:
        return self.normalize(self.fields)


class TankSloshingStage2(_TankBase):
    """Stage 2: pre-encoded latent windows of in_tw + out_tw frames; the
    reference's window-sampling quirk is opt-in (``cfg.window_quirk``).

    Call ``encode_dataset(encode_fn, device)`` once before training; train
    batches are (z_in [b, in_tw, h, w, c], z_out [b, out_tw, h, w, c])."""

    def __init__(self, cfg, train_mode: bool = True):
        super().__init__(cfg, train_mode)
        self.in_tw = cfg.in_tw
        self.out_tw = cfg.out_tw
        self.encoded: Optional[np.ndarray] = None

    def __len__(self):
        if self.train_mode:
            return self.n_cases * (self.case_len - self.in_tw - self.out_tw)
        return self.n_cases

    def encode_dataset(self, encode_fn: Callable, device, batch: int = 32):
        """Encode every frame once, `batch` frames per call (the last call
        padded with repeats of its last frame, so every call has one shape).
        encode_fn: [b, H, W, 4] -> [b, h, w, c], tensors on `device`. The
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
        self.encoded = z.reshape(self.n_cases, self.case_len, *z.shape[1:])

    def _window(self, indices):
        # the reference divides by case_len where __len__ counts case_len -
        # in_tw - out_tw windows (twophase_flow_stage2.py:150 against :55),
        # which skews the case / time pairing; opt-in
        span = self.case_len - self.in_tw - self.out_tw
        denom = self.case_len if self.cfg.window_quirk else span
        return indices // denom, indices % span

    def _times(self, indices):
        case, start = self._window(indices)
        return case[:, None], start[:, None] + np.arange(self.in_tw + self.out_tw)[None, :]

    def get_batch(self, indices: np.ndarray):
        """Windows of the corpus by index: (z_in, z_out), numpy arrays."""
        if self.encoded is None:
            raise RuntimeError("call encode_dataset() first")
        case, t_idx = self._times(indices)
        z = self.encoded[case, t_idx]
        return z[:, : self.in_tw], z[:, self.in_tw:]

    def eval_trajectories(self):
        """(x0 [n, in_tw, H, W, 4], y [n, steps, H, W, 4]), normalised."""
        traj = self.normalize(self.fields)
        return traj[:, : self.in_tw], traj[:, self.in_tw:]


class SimpleTankSloshingData(TankSloshingStage2):
    """Pixel-space stage-2 twin (reference: twophase_flow_stage2.py:393-761):
    the same windows with the normalised fields in place of latents; no
    encode pre-pass."""

    def get_batch(self, indices: np.ndarray):
        case, t_idx = self._times(indices)
        x = self.normalize(self.fields)[case, t_idx]
        return x[:, : self.in_tw], x[:, self.in_tw:]


class ConditionalTankSloshingStage2(TankSloshingStage2):
    """The conditional family's stage 2: each window also carries its
    case's normalised parameter; train batches are (z_in, z_out, param
    [b]) and ``eval_trajectories`` returns (x0, y, param [n])."""

    conditional = True

    def get_batch(self, indices: np.ndarray):
        z_in, z_out = super().get_batch(indices)
        case, _ = self._window(indices)
        return z_in, z_out, self.normalize_param(self.params_raw[case])

    def eval_trajectories(self):
        x, y = super().eval_trajectories()
        return x, y, self.normalize_param(self.params_raw)
