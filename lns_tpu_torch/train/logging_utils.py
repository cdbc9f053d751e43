"""Run directories, metric logging and figures (counterpart of
``lns_tpu.train.logging_utils``).

Keeps the reference's log_dir layout (``checkpoints/``, ``samples/``,
``code_cache/`` and a config snapshot; training_utils.py:80-100), a JSONL
metrics stream, wandb when it imports, and the PNG figures of
training_utils.py:124-142 and train_stage2_ns2d.py:277-291. matplotlib is
imported inside the figure functions; where it is missing a figure is
skipped with one printed line, and nothing else depends on it.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch


def prepare_training(log_dir: str, overwrite_exist: bool, config_path: Optional[str] = None,
                     config_dict: Optional[dict] = None) -> None:
    """Make the log tree; copy the config file, dump the config as JSON and
    snapshot this package's source into ``code_cache/``."""
    if os.path.exists(log_dir):
        if not overwrite_exist:
            raise RuntimeError("log_dir already exists and overwrite argument is False; "
                               "check the config")
        shutil.rmtree(log_dir)
    for sub in ("checkpoints", "samples", "code_cache"):
        os.makedirs(os.path.join(log_dir, sub))
    if config_path and os.path.exists(config_path):
        shutil.copy(config_path, os.path.join(log_dir, "config.yaml"))
    if config_dict is not None:
        with open(os.path.join(log_dir, "config.json"), "w") as f:
            json.dump(config_dict, f, indent=2, default=str)
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(pkg_dir, os.path.join(log_dir, "code_cache", "lns_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))


class MetricLogger:
    """stdout + JSONL (+ wandb when it imports) scalar logger.

    A 0-d tensor is logged without fetching it: it is buffered, and the
    buffer is fetched in one stacked copy at a flush point (every
    `flush_every` records, at a record that is echoed or holds no tensor,
    and at ``finish``). So a train step that logs its loss does not wait for
    the card. With wandb active values are fetched at once (wandb needs
    them)."""

    def __init__(self, log_dir: str, project: Optional[str] = None,
                 config: Optional[dict] = None, use_wandb: bool = True, flush_every: int = 512):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._step = 0
        self._pending = []  # [(record, [(key, 0-d tensor), ...]), ...]
        self._flush_every = flush_every
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project=project, config=config)
                self.wandb = wandb

    def _flush_pending(self):
        if not self._pending:
            return
        tensors = [t.detach().float() for _, dev in self._pending for _, t in dev]
        vals = iter(torch.stack(tensors).cpu().tolist())  # one copy to the host
        for rec, dev in self._pending:
            for key, _ in dev:
                rec[key] = next(vals)
            self._f.write(json.dumps(rec) + "\n")
        self._pending = []
        self._f.flush()

    def log(self, metrics: dict, echo: bool = False):
        step = self._step
        self._step += 1
        rec = {"step": step, "time": time.time()}
        defer = self.wandb is None and not echo
        dev = []
        for k, v in metrics.items():
            if defer and isinstance(v, torch.Tensor) and v.dim() == 0:
                dev.append((k, v))
            else:
                rec[k] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        if dev:
            self._pending.append((rec, dev))
            if len(self._pending) >= self._flush_every:
                self._flush_pending()
            return
        self._flush_pending()  # keep the JSONL in order
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if echo:
            print(" ".join(f"{k}={v}" for k, v in rec.items() if k != "time"))
        if self.wandb is not None:
            self.wandb.log({k: rec[k] for k in metrics}, step=step)

    def log_image(self, key: str, png_path: str):
        """Push a saved PNG to wandb as an Image (the reference logs its eval
        figures so, train_stage2_ns2d.py:277-291); the file on disk is the
        artifact, so a missing file (a skipped figure) is not pushed."""
        if self.wandb is not None and os.path.exists(png_path):
            self.wandb.log({key: self.wandb.Image(png_path)}, step=self._step)

    def finish(self):
        self._flush_pending()
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()


def _pyplot(what: str, out_path: str):
    """matplotlib's pyplot on the Agg backend, or None (with one printed
    line) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"{what}: matplotlib is not installed; {out_path} skipped")
        return None
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def log_sequence(imgs, out_path: str):
    """[b, t, h, w] grid PNG ('twilight' colour map; training_utils.py:124-142)."""
    plt = _pyplot("log_sequence", out_path)
    if plt is None:
        return
    from mpl_toolkits.axes_grid1 import ImageGrid

    imgs = np.asarray(imgs)
    b, t = imgs.shape[:2]
    flat = imgs.reshape(b * t, *imgs.shape[2:])
    fig = plt.figure(figsize=(8.0, 8.0))
    grid = ImageGrid(fig, 111, nrows_ncols=(b, t))
    for ax, im_no in zip(grid, np.arange(b * t)):
        ax.imshow(flat[im_no], cmap="twilight")
        ax.axis("off")
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()


def plot_error_curve(err: np.ndarray, err_std: np.ndarray, out_path: str):
    """Rollout error against time, mean +- std (train_stage2_ns2d.py:277-291)."""
    plt = _pyplot("plot_error_curve", out_path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=[6, 4], dpi=200)
    x = np.arange(len(err))
    ax.plot(x, err, color="b")
    ax.fill_between(x, err - err_std, err + err_std, alpha=0.3, color="b")
    plt.ylabel(r"Relative $\mathcal{L}_2$ norm", fontsize=12)
    plt.xlabel("Timesteps", fontsize=12)
    plt.grid(which="both", linestyle="-.")
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()
