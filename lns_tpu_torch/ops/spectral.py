"""Spectral (FNO) convolutions (reference: modules/basics.py:55-221), the
counterpart of ``lns_tpu.ops.spectral``.

rfft over the spatial axes, keep the retained mode blocks, contract each
with its complex weight bank over channels (2 banks in 2D for the + and -
row modes, 4 in 3D), irfft back. Weights are real ``[..., 2]`` pairs, as
the reference stores them, viewed as complex at use. The transforms run in
f32 and the result is cast back to the input's dtype.

Modules take channel-first tensors (``[B, C, N]``, ``[B, C, H, W]``,
``[B, C, D, H, W]``) in channels-last memory; internally they work on the
channels-last view, so the output is channels-last too. The FFTs are
``torch.fft`` library calls and the mode contraction a complex einsum, as
the JAX package computes them outside any Pallas kernel. Where a block's
modes exceed what the transform holds (``modes > n // 2 + 1`` on the last
axis, ``modes > n`` on another) the layer raises, as the JAX einsum does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def batchmul1d(x_ft: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, m, i), (i, o, m) -> (b, m, o)  [channels-last]"""
    return torch.einsum("bmi,iom->bmo", x_ft, w)


def batchmul2d(x_ft: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, mx, my, i), (i, o, mx, my) -> (b, mx, my, o)"""
    return torch.einsum("bxyi,ioxy->bxyo", x_ft, w)


def batchmul3d(x_ft: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, mx, my, mz, i), (i, o, mx, my, mz) -> (b, mx, my, mz, o)"""
    return torch.einsum("bxyzi,ioxyz->bxyzo", x_ft, w)


def as_complex(w: torch.Tensor) -> torch.Tensor:
    """A real ``[..., 2]`` weight as complex64 ``[...]``."""
    return torch.view_as_complex(w.float().contiguous())


def check_modes(spatial: Sequence[int], modes: Sequence[int]) -> None:
    """Raise where a mode block is wider than the transform: the last axis
    holds n // 2 + 1 rfft columns, every other axis n rows."""
    held = list(spatial[:-1]) + [spatial[-1] // 2 + 1]
    if any(m > n for m, n in zip(modes, held)):
        raise ValueError(f"spectral conv: modes {tuple(modes)} exceed the {tuple(held)} "
                         f"frequencies that a {tuple(spatial)} field's rfft holds")


def _spectral_weight(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, 2))


def _dft_basis(n: int, k: torch.Tensor):
    """cos and sin of 2 pi x k / n for x in [0, n) and the frequencies k
    (f64): [n, len(k)] each, f64 on k's device (the JAX package builds its
    bases in f64 too)."""
    ang = (2 * math.pi / n) * torch.arange(n, dtype=torch.float64, device=k.device)[:, None] * k
    return torch.cos(ang), torch.sin(ang)


def irfft_modes(z: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.fft.irfft(z padded with zeros to n // 2 + 1 modes, n, dim=1)``
    for z [B, m, C] complex, as a matmul with the m retained modes' cos and
    sin bases (``_dft_basis``, used in f32): the columns
    0 < k < n / 2 count twice (their conjugate pair), k = 0 and the Nyquist
    column once, and those two columns' imaginary parts drop out (their sin
    rows are zero). Returns [B, n, C] f32.

    The 1D spectral conv synthesises so because cuFFT's batched 1D c2r gives
    wrong results on the H100 at some sizes (torch 2.11.0+cu128, CUDA 12.8:
    ~1e-1 x max|ref| at n >= 1024 with >= 2048 transforms, e.g. 32 x 64
    channels of 1,024 points; 2D and 3D transforms at the paths' sizes are
    exact to f32), and this form is exact on every device."""
    m = z.shape[1]
    cos, sin = _dft_basis(n, torch.arange(m, dtype=torch.float64, device=z.device))
    fac = torch.full((m,), 2.0 / n, dtype=torch.float64, device=z.device)
    fac[0] = 1.0 / n
    if n % 2 == 0 and m - 1 == n // 2:
        fac[-1] = 1.0 / n
    cos, sin = (cos * fac).float(), (sin * fac).float()
    return torch.einsum("bmc,tm->btc", z.real, cos) - torch.einsum("bmc,tm->btc", z.imag, sin)


class SpectralConv1d(nn.Module):
    """1D Fourier layer on x [B, C, N] (weights [I, O, modes, 2]). The
    inverse transform of the retained modes is ``irfft_modes``."""

    def __init__(self, in_channels: int, out_channels: int, modes: int):
        super().__init__()
        self.out_channels = out_channels
        self.modes = modes
        self.weights = _spectral_weight(in_channels, out_channels, modes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1]
        check_modes((n,), (self.modes,))
        x_ft = torch.fft.rfft(x.movedim(1, -1).float(), dim=1)  # [b, n//2+1, c]
        out = batchmul1d(x_ft[:, :self.modes], as_complex(self.weights))
        return irfft_modes(out, n).to(x.dtype).movedim(-1, 1)


def spectral_conv2d_fft(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, m1: int, m2: int,
                        emb1: torch.Tensor = None, emb2: torch.Tensor = None) -> torch.Tensor:
    """The 2D Fourier layer on the channels-last view xl [B, H, W, I]: rows
    [0, m1) through w1 and [H - m1, H) through w2 (complex [I, O, m1, m2]),
    written top first, then bottom, so the bottom block wins where the two
    overlap (2 m1 > H), as the JAX package's ``.set`` order does; each
    block's modes first scaled by its complex ``emb`` [B, m1, m2] where
    given (the conditional form). Returns [B, H, W, O] f32."""
    b, h, w, _ = x.shape
    check_modes((h, w), (m1, m2))
    x_ft = torch.fft.rfft2(x.float(), dim=(1, 2))  # [b, h, w//2+1, i]
    top, bot = x_ft[:, :m1, :m2], x_ft[:, h - m1:, :m2]
    if emb1 is not None:
        top, bot = top * emb1[..., None], bot * emb2[..., None]
    out_ft = x_ft.new_zeros(b, h, w // 2 + 1, w1.shape[1])
    out_ft[:, :m1, :m2] = batchmul2d(top, w1)
    out_ft[:, h - m1:, :m2] = batchmul2d(bot, w2)
    return torch.fft.irfft2(out_ft, s=(h, w), dim=(1, 2))


def spectral_conv2d_dft(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, modes1: int,
                        modes2: int) -> torch.Tensor:
    """``SpectralConv2d`` as matmuls with the truncated DFT bases, no FFT
    (``lns_tpu.ops.spectral.spectral_conv2d_dft``). x [B, H, W, C] (the
    channels-last view); w1, w2 real [I, O, m1, m2, 2]. Returns x's dtype.
    The synthesis doubles the columns 0 < k < W / 2 (their conjugate pair)
    and keeps k = 0 and, for an even W whose last retained column is W / 2,
    the Nyquist column once. Where the two row blocks overlap both are
    summed (the FFT form writes the bottom one over the top)."""
    b, h, w, c = x.shape
    m1, m2 = modes1, modes2
    f64 = dict(dtype=torch.float64, device=x.device)
    rows = torch.cat([torch.arange(m1, **f64), torch.arange(h - m1, h, **f64)])
    # e^{-2 pi i k x / n} = cos - i sin, the bases in f32
    ch_c, ch_s = (t.float() for t in _dft_basis(h, rows))  # [h, 2 m1]
    cw_c, cw_s = (t.float() for t in _dft_basis(w, torch.arange(m2, **f64)))  # [w, m2]
    e = torch.einsum
    xf = x.float()
    xr_re = e("bhwc,hr->brwc", xf, ch_c)
    xr_im = -e("bhwc,hr->brwc", xf, ch_s)
    xf_re = e("brwc,wk->brkc", xr_re, cw_c) + e("brwc,wk->brkc", xr_im, cw_s)
    xf_im = e("brwc,wk->brkc", xr_im, cw_c) - e("brwc,wk->brkc", xr_re, cw_s)

    def apply_w(re, im, wk):
        wr, wi = wk[..., 0].permute(0, 2, 3, 1), wk[..., 1].permute(0, 2, 3, 1)
        return (e("brkc,crko->brko", re, wr) - e("brkc,crko->brko", im, wi),
                e("brkc,crko->brko", re, wi) + e("brkc,crko->brko", im, wr))

    top_re, top_im = apply_w(xf_re[:, :m1], xf_im[:, :m1], w1.float())
    bot_re, bot_im = apply_w(xf_re[:, m1:], xf_im[:, m1:], w2.float())
    fac = torch.full((m2,), 2.0, device=x.device)
    fac[0] = 1.0
    if w % 2 == 0 and m2 - 1 == w // 2:
        fac[-1] = 1.0
    fac = fac[None, None, :, None]
    o_re = torch.cat([top_re, bot_re], dim=1) * fac  # [b, 2 m1, m2, o]
    o_im = torch.cat([top_im, bot_im], dim=1) * fac
    yr_re = e("brko,hr->bhko", o_re, ch_c) - e("brko,hr->bhko", o_im, ch_s)
    yr_im = e("brko,hr->bhko", o_im, ch_c) + e("brko,hr->bhko", o_re, ch_s)
    y = e("bhko,wk->bhwo", yr_re, cw_c) - e("bhko,wk->bhwo", yr_im, cw_s)
    return (y / (h * w)).to(x.dtype)


class SpectralConv2d(nn.Module):
    """2D Fourier layer on x [B, C, H, W]: keeps rows [0, modes1) and
    [H - modes1, H) of the height spectrum and columns [0, modes2) of the
    half width spectrum, with a weight bank ([I, O, modes1, modes2, 2]) for
    each row block. ``use_dft_matmul`` runs ``spectral_conv2d_dft``."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 use_dft_matmul: bool = False):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.use_dft_matmul = use_dft_matmul
        self.weights1 = _spectral_weight(in_channels, out_channels, modes1, modes2)
        self.weights2 = _spectral_weight(in_channels, out_channels, modes1, modes2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xl = x.movedim(1, -1)
        if self.use_dft_matmul:
            y = spectral_conv2d_dft(xl, self.weights1, self.weights2, self.modes1, self.modes2)
        else:
            y = spectral_conv2d_fft(xl, as_complex(self.weights1), as_complex(self.weights2),
                                    self.modes1, self.modes2)
        return y.to(x.dtype).movedim(-1, 1)


class SpectralConv3d(nn.Module):
    """3D Fourier layer on x [B, C, D, H, W]: four weight banks
    (``weights1``-``weights4``, [I, O, m1, m2, m3, 2]) for the (+/- D,
    +/- H) corner blocks of the spectrum, written in that order."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 modes3: int):
        super().__init__()
        self.out_channels = out_channels
        self.modes = (modes1, modes2, modes3)
        for i in range(4):
            self.register_parameter(f"weights{i + 1}", _spectral_weight(
                in_channels, out_channels, modes1, modes2, modes3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[2:]
        m1, m2, m3 = self.modes
        check_modes((d, h, w), self.modes)
        x_ft = torch.fft.rfftn(x.movedim(1, -1).float(), dim=(1, 2, 3))
        out_ft = x_ft.new_zeros(x.shape[0], d, h, w // 2 + 1, self.out_channels)
        for i, (s1, s2) in enumerate(((slice(None, m1), slice(None, m2)),
                                      (slice(d - m1, None), slice(None, m2)),
                                      (slice(None, m1), slice(h - m2, None)),
                                      (slice(d - m1, None), slice(h - m2, None)))):
            w_i = as_complex(getattr(self, f"weights{i + 1}"))
            out_ft[:, s1, s2, :m3] = batchmul3d(x_ft[:, s1, s2, :m3], w_i)
        y = torch.fft.irfftn(out_ft, s=(d, h, w), dim=(1, 2, 3))
        return y.to(x.dtype).movedim(-1, 1)


def spectral(in_ch: int, out_ch: int, modes: Sequence[int]) -> nn.Module:
    """The spectral conv of 1, 2 or 3 dims that `modes` name."""
    modes = list(modes)
    if len(modes) == 1:
        return SpectralConv1d(in_ch, out_ch, modes[0])
    if len(modes) == 2:
        return SpectralConv2d(in_ch, out_ch, *modes)
    if len(modes) == 3:
        return SpectralConv3d(in_ch, out_ch, *modes)
    raise ValueError("modes must have 1-3 entries")
