"""Batched on-device minimizer sketch (ONT preset, JAX).

For ``2k <= 32`` (the ava-ont preset: k=15) the canonical k-mer and its
minimap2 ``hash64`` fit in uint32: every arithmetic step of the 64-bit
hash masked to ``2k`` bits is reproduced exactly by 32-bit modular
arithmetic (shifts never push surviving bits past bit 31).  This keeps
the hot sketch path in native 32-bit lanes on the VPU instead of
emulated 64-bit.

Selection implements the same window-min cover rule as
``sketch.minimizers_numpy`` (see that module's docstring for the
equivalence argument with minimap2's loop), vectorised over a padded
``[B, L]`` batch.  Padding (code 4) behaves exactly like ambiguous
bases, and the per-read final-window push is applied at each true read
end via a batched gather.

Reference behavior being reproduced: SURVEY.md C15 sketch stage
(`preset.rs:24-27` parameters; positions/strand conventions from
minimap2's anchor generation, consumed by `aligner.rs:204-303`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def hash32(key: jnp.ndarray, mask: int) -> jnp.ndarray:
    """minimap2 hash64 restricted to a <=32-bit mask (exact)."""
    m = jnp.uint32(mask)
    key = (~key + (key << 21)) & m
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & m  # * 265
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & m  # * 21
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & m
    return key


def sketch_core(
    codes: jnp.ndarray,  # [B, L] uint8 (4 = ambiguous/padding)
    lengths: jnp.ndarray,  # [B] int32
    *,
    k: int,
    w: int,
    max_minimizers: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sketch a padded batch.

    Returns ``(mhash [B,M] uint32, mpos [B,M] int32, mstrand [B,M] int32,
    mcount [B] int32)`` with ``0xFFFFFFFF`` hash padding.  ``M`` =
    ``max_minimizers``; overflowing minimizers (beyond M) are dropped
    (callers size M at ~0.5*L; expected density is 2/(w+1)).
    """
    assert 2 * k <= 32, "uint32 fast path requires 2k <= 32"
    B, L = codes.shape
    mask = (1 << (2 * k)) - 1
    c = codes.astype(jnp.uint32)
    ambig = c >= 4
    csafe = jnp.where(ambig, 0, c)

    # k-mer values at every end position i (bits of bases i-k+1..i)
    fwd = jnp.zeros((B, L), dtype=jnp.uint32)
    rev = jnp.zeros((B, L), dtype=jnp.uint32)
    for j in range(k):
        shifted = jnp.pad(csafe[:, : L - j], ((0, 0), (j, 0))) if j else csafe
        fwd = fwd | (shifted << (2 * j))
        rev = rev | ((jnp.uint32(3) ^ shifted) << (2 * (k - 1 - j)))
    fwd = fwd & jnp.uint32(mask)
    rev = rev & jnp.uint32(mask)

    # validity: k consecutive non-ambiguous bases ending at i
    okc = jnp.cumsum(jnp.where(ambig, 0, 1).astype(jnp.int32), axis=1)
    okc_km = jnp.pad(okc[:, : L - k], ((0, 0), (k, 0)))  # okc[i-k], 0 for i<k
    valid = (okc - okc_km) == k
    valid = valid & (jnp.arange(L) >= k - 1)
    valid = valid & (fwd != rev)  # palindrome guard (impossible for odd k)
    in_read = jnp.arange(L)[None, :] < lengths[:, None]
    valid = valid & in_read

    strand = (fwd >= rev).astype(jnp.int32)
    x = hash32(jnp.minimum(fwd, rev), mask)
    INF = jnp.uint32(0xFFFFFFFF)
    xm = jnp.where(valid, x, INF)

    # window min ending at e over [e-w+1, e]
    wmin = xm
    for d in range(1, w):
        sh = jnp.pad(xm[:, : L - d], ((0, 0), (d, 0)), constant_values=INF)
        wmin = jnp.minimum(wmin, sh)
    # gate: all w k-mers in window valid
    vcum = jnp.cumsum(valid.astype(jnp.int32), axis=1)
    vcum_w = jnp.pad(vcum[:, : L - w], ((0, 0), (w, 0)))
    gated = (vcum - vcum_w) == w
    gated = gated & (jnp.arange(L) >= w + k - 2)

    sel = jnp.zeros((B, L), dtype=bool)
    for d in range(w):
        if d == 0:
            g, m = gated, wmin
        else:
            g = jnp.pad(gated[:, d:], ((0, 0), (0, d)))
            m = jnp.pad(wmin[:, d:], ((0, 0), (0, d)))
        sel = sel | (g & (m == xm) & valid)

    # first-window amendment (mirrors sketch._select_minimizers): at the
    # first full window the loop pushes ties of the *prefix* minimum and
    # drops the held minimum when the window-closing k-mer ties it
    e0 = w + k - 2
    if L > e0 and w >= 2:
        prefix = xm[:, k - 1 : e0]  # [B, w-1]
        pmin = jnp.min(prefix, axis=1)
        arg_rev = jnp.argmin(prefix[:, ::-1], axis=1)
        held_rel = (w - 2) - arg_rev
        long_enough = lengths >= (w + k - 1)
        ok = (pmin != INF) & long_enough
        win = xm[:, k - 1 : e0 + 1]  # [B, w]
        cols = jnp.arange(w)
        add = (win == pmin[:, None]) & ok[:, None] & (cols[None, :] != held_rel[:, None])
        sel = sel.at[:, k - 1 : e0 + 1].set(sel[:, k - 1 : e0 + 1] | add)
        closing_tie = (xm[:, e0] == pmin) & ok
        held_abs = k - 1 + held_rel
        held_mask = jnp.arange(L, dtype=jnp.int32)[None, :] == held_abs[:, None]
        sel = sel & ~(held_mask & closing_tie[:, None])

    # final-window push: latest min over positions [n-w, n-1] of each read
    # (one-hot select instead of a 2D scatter)
    tail_idx = jnp.maximum(lengths[:, None] - w + jnp.arange(w)[None, :], 0)  # [B, w]
    tail_x = jnp.take_along_axis(xm, tail_idx, axis=1)
    # latest tie: scan from the right
    rev_order = tail_x[:, ::-1]
    arg_rev = jnp.argmin(rev_order, axis=1)
    tie_pos = jnp.take_along_axis(tail_idx, (w - 1 - arg_rev)[:, None], axis=1)[:, 0]
    tie_val = jnp.take_along_axis(xm, tie_pos[:, None], axis=1)[:, 0]
    has_tail = tie_val != INF
    cols = jnp.arange(L, dtype=jnp.int32)[None, :]
    sel = sel | ((cols == tie_pos[:, None]) & has_tail[:, None])

    # compact to [B, M] by sorting selected positions to the front
    # (stable single-key sort; position is recovered from the sort key).
    # The hash fits 2k bits, so strand rides in bit 0 of the payload
    # when 2k+1 <= 32, cutting the sort to two operands.
    M = max_minimizers
    mcount = jnp.sum(sel, axis=1).astype(jnp.int32)  # raw count (uncapped)
    ckey = jnp.where(sel, cols, cols + L)
    if 2 * k + 1 <= 32:
        xs2 = (x << 1) | strand.astype(jnp.uint32)
        ckey_s, xs2_s = jax.lax.sort(
            (ckey, jnp.where(sel, xs2, INF)), dimension=1, num_keys=1, is_stable=True
        )
        x_s, strand_s = xs2_s >> 1, (xs2_s & 1).astype(jnp.int32)
    else:
        ckey_s, x_s, strand_s = jax.lax.sort(
            (ckey, jnp.where(sel, x, INF), strand),
            dimension=1, num_keys=1, is_stable=True,
        )
    mhash = x_s[:, :M]
    mpos = jnp.where(ckey_s[:, :M] < L, ckey_s[:, :M], 0)
    mstrand = jnp.where(ckey_s[:, :M] < L, strand_s[:, :M], 0)
    mhash = jnp.where(ckey_s[:, :M] < L, mhash, INF)
    return mhash, mpos, mstrand, mcount


sketch_batch = functools.partial(
    jax.jit, static_argnames=("k", "w", "max_minimizers")
)(sketch_core)


def sketch_batch_exact(
    codes: np.ndarray,
    lengths: np.ndarray,
    *,
    k: int,
    w: int,
    max_minimizers: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Device sketch with exact host fallback for N-containing reads.

    Returns host numpy arrays ``(mhash, mpos, mstrand, mcount)``; rows of
    reads containing ambiguous bases are recomputed with the scalar
    oracle (see ``sketch.sketch_read``), so results are bit-exact for
    every read while the common case stays on-device.
    """
    from .sketch import needs_scalar_sketch, sketch_scalar

    mhash, mpos, mstrand, mcount = map(
        np.asarray,
        sketch_batch(
            jnp.asarray(codes), jnp.asarray(lengths), k=k, w=w, max_minimizers=max_minimizers
        ),
    )
    mhash = mhash.copy()
    mpos = mpos.copy()
    mstrand = mstrand.copy()
    mcount = mcount.copy()
    for b in range(codes.shape[0]):
        row = codes[b, : lengths[b]]
        if not needs_scalar_sketch(row, k, w, False):
            continue
        mz = sketch_scalar(row, k, w, False)
        cnt = min(len(mz.key), max_minimizers)
        mhash[b] = 0xFFFFFFFF
        mhash[b, :cnt] = (mz.key[:cnt] >> np.uint64(8)).astype(np.uint32)
        mpos[b, :cnt] = mz.pos[:cnt]
        mstrand[b, :cnt] = mz.strand[:cnt]
        mcount[b] = len(mz.key)  # raw count; truncation detectable
    return mhash, mpos, mstrand, mcount
