"""P2: the paired-slot block-ELL SpMM (experiments/bell_pair_proto.py).

The prototype fuses two slots of a block row into one (bs, 2bs)·(2bs, k)
contraction per step, against K11's one (bs, bs)·(bs, k) per slot.  Its
CUDA entry (``cgx_bell_spmm_paired`` in ``cgx_torch/csrc/bsr.cu``) is
K11's with two slots staged per shared-memory round, on the path
``bell_plan(..., slots=2)`` gives (K11's path for the shape): half the
barriers and loop trips per block row, the same terms in the same order, so
its ``Y`` equals K11's bit for bit.  ``wb`` must be even (the
reference asserts it; here it raises ``ValueError``).  The plain version
:func:`bell_pair_reference` does one matmul per pair of slots.
``bell_pair_launches`` counts launches.

Run on the card: ``python3 -m cgx_torch.experiments.bell_pair_proto``
(the reference's sizes: 512 block rows, wb 8, bs 64, k 256, in fp32 and
bf16).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from cgx_torch.kernels import bsr as kb

__all__ = ["bell_spmm_paired", "bell_pair_reference", "bell_pair_launches",
           "main"]

bell_pair_launches = 0


def _check(block_cols, values, xb, k):
    nbr, wb, bs, _ = values.shape
    if wb % 2:
        raise ValueError(f"bell_spmm_paired pairs slots: wb={wb} must be "
                         "even")
    if xb.dim() != 3 or tuple(xb.shape[1:]) != (bs, k):
        raise ValueError(f"bell_spmm_paired: xb must be (nbc, {bs}, {k}), "
                         f"got {tuple(xb.shape)}")
    if tuple(block_cols.shape) != (nbr, wb):
        raise ValueError(f"bell_spmm_paired: block_cols must be ({nbr}, "
                         f"{wb}), got {tuple(block_cols.shape)}")


def bell_pair_reference(block_cols, values, xb, *, k: int) -> torch.Tensor:
    """P2's plain version on any device: ``Y[i] = Σ_pairs [v_j v_j+1] @
    [x_cj; x_cj+1]``, one matmul per pair of slots, in float32."""
    _check(block_cols, values, xb, k)
    nbr, wb, bs, _ = values.shape
    xo = xb.float()
    cols = block_cols.long()
    y = torch.zeros((nbr, bs, k), dtype=torch.float32, device=xb.device)
    for j in range(0, wb, 2):
        vv = torch.cat([values[:, j], values[:, j + 1]], dim=2).float()
        xx = torch.cat([xo[cols[:, j]], xo[cols[:, j + 1]]], dim=1)
        y += torch.matmul(vv, xx)
    return y


def bell_spmm_paired(block_cols: torch.Tensor, values: torch.Tensor,
                     xb: torch.Tensor, *, k: int) -> torch.Tensor:
    """``Y = A @ X`` with two slots per contraction step: ``values`` ``(nbr,
    wb, bs, bs)`` (wb even), ``block_cols`` ``(nbr, wb)`` int32, ``xb``
    ``(nbc, bs, k)`` → ``(nbr, bs, k)`` float32.  The CUDA kernel takes
    float32 or bfloat16 operands (both alike) and equals K11 bit for bit; a
    CPU ``xb`` takes the plain version."""
    global bell_pair_launches
    _check(block_cols, values, xb, k)
    if xb.device.type == "cpu":
        return bell_pair_reference(block_cols, values, xb, k=k)
    if xb.device.type != "cuda":
        raise ValueError(f"bell_spmm_paired: unsupported device {xb.device}")
    nbr, _, bs, _ = values.shape
    values, cols, x = kb.checked_operands("bell_spmm_paired", values,
                                          block_cols, xb.reshape(-1, k))
    y = torch.empty((nbr * bs, k), dtype=torch.float32, device=x.device)
    if kb.launch_rows("cgx_bell_spmm_paired", "bell_spmm_paired", values,
                      cols, x, y, 0, nbr, slots=2) is not None:
        bell_pair_launches += 1
    return y.reshape(nbr, bs, k)


def main() -> None:
    """The reference's sizes in fp32 and bf16: P2 against K11 (bit for bit)
    and its plain version (1e-5 of the peak), each timed beside K11."""
    from cgx_torch.experiments import interleaved_ms, require_card

    dev, card = require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    nbr, wb, bs, k = 512, 8, 64, 256
    for dt in (torch.float32, torch.bfloat16):
        vals = torch.from_numpy(rng.standard_normal(
            (nbr, wb, bs, bs)).astype(np.float32)).to(dev).to(dt)
        cols = torch.from_numpy(rng.integers(0, nbr, (nbr, wb))
                                .astype(np.int32)).to(dev)
        a = kb.BlockELL(values=vals, block_cols=cols,
                        shape=(nbr * bs, nbr * bs))
        x = torch.from_numpy(rng.standard_normal((nbr * bs, k))
                             .astype(np.float32)).to(dev).to(dt)
        xb = x.reshape(-1, bs, k)
        y_ref = kb.bell_spmm(a, x, engine="resident").reshape(nbr, bs, k)
        y_p = bell_spmm_paired(cols, vals, xb, k=k)
        y_plain = bell_pair_reference(cols, vals, xb, k=k)
        same = torch.equal(y_p, y_ref)
        err = float((y_p - y_plain).abs().max() / y_plain.abs().max())
        print(f"[{card}] {dt}: paired equal to K11 bit for bit: {same}; "
              f"max rel diff to the plain version {err:.1e}")
        if not same or err > 1e-5:
            sys.exit(1)
        ms = interleaved_ms({
            "resident": lambda: kb.bell_spmm(a, x, engine="resident"),
            "paired": lambda: bell_spmm_paired(cols, vals, xb, k=k),
            "plain": lambda: bell_pair_reference(cols, vals, xb, k=k)},
            inner=5)
        flops = 2 * nbr * wb * bs * bs * k
        for mode, t in ms.items():
            print(f"[{card}] {dt} {mode:9s}: {t * 1e3:8.1f} us "
                  f"{flops / (t * 1e-3) / 1e12:6.2f} TFLOP/s")


if __name__ == "__main__":
    main()
