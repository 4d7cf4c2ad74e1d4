"""Paged KV-cache primitives: page-pool writes, block-table gathers,
gather attention, and the paged flash decode (CUDA kernel K4).

The PyTorch counterpart of ``dtf_tpu/ops/paged_attention.py``; the
layout and its invariants are the same:

  page pool    -- one [num_pages, page_size, H, Dh] tensor per layer per
                  K/V, shared by every slot.  Logical position ``p`` of a
                  slot lives at pool row ``block_table[slot, p // page]``,
                  offset ``p % page``.
  block table  -- [B, max_pages_per_slot] int32 page ids, kept on the
                  host by the serving engine's allocator.  Entries for
                  unallocated tail pages are 0.
  scratch page -- pool page 0 is never handed to a request.  Rows of a
                  fixed-shape decode batch that are not decoding carry an
                  all-zeros block-table row, so their garbage writes and
                  reads land on page 0, which no live sequence reads.

The pools are updated IN PLACE (``write_pages`` returns the same
tensor): where the JAX code donated the cache buffers to each jitted
step (``donate_argnums``) so XLA could reuse them, PyTorch simply
writes into them.

Two formulations of attention over pages:

  gather (``paged_attention``)   -- materialize each row's window,
      mask, dense softmax: the oracle, and the CPU path.
  kernel (``paged_flash_decode``) -- on CUDA, ``csrc/paged_decode.cu``
      reads the pages through the block table inside the kernel, with no
      gathered window and dead pages never read; on the CPU its plain
      version, :func:`paged_flash_decode_reference`.  The kernel splits
      each row's keys into runs of ``KEYS_PER_SPLIT``, one block each,
      and folds the runs' partial results in a second pass: two device
      kernels a call, one count on ``launches``.

``paged_attention_auto`` picks by device: the kernel for CUDA tensors,
the gather (with its ``window_pages`` trim) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dtf_tpu_torch.obs import ledger
from dtf_tpu_torch.ops import _build
from dtf_tpu_torch.ops import blockwise as bw
from dtf_tpu_torch.ops.flash_attention import KERNEL_DTYPES, KERNEL_HEAD_DIMS

# launches of the CUDA kernel in this process (calls: each runs the
# split pass and the combine)
launches = 0

# keys of a row that one block of the kernel's split pass walks: a
# multiple of 64, the chunk routes' key tile.  Chosen on the card from
# chip_smoke.py's sweep (PERF.md): 64 is the fastest or within 5% of it
# on every case swept, and the f32 chunk route, whose tiles cost the
# most, gains most from the shorter walks
KEYS_PER_SPLIT = 64


def num_splits(m_pages: int, page_size: int, keys_per_split: int) -> int:
    """Blocks a row's keys are split over: sized from the table's width
    (M * page), not from ``index``, which would need the host to read
    the device."""
    return -(-m_pages * page_size // keys_per_split)


def live_pairs(index, s: int, capacity: int) -> int:
    """(query, key) pairs of one head over a paged history: row b's
    query i (position index[b] + i) sees keys 0 .. index[b] + i, within
    the table's ``capacity`` (M * page) -- the keys K4 reads, dead
    pages skipped.  ``index`` is a host sequence."""
    return sum(min(int(i) + j + 1, capacity)
               for i in index for j in range(s))


def _report_ops(q, block_table, index, page_size: int) -> None:
    """The ledger's operation count of one K4 call (the count its bound
    uses: 4 D operations per live pair); a no-op outside a count.  It
    reads ``index`` on the host: inside a count only."""
    if ledger.counting():
        _, s, h, d = q.shape
        ledger.kernel_ops(4 * h * d * live_pairs(
            index.tolist(), s, block_table.shape[1] * page_size))


def cached_attention(q, k, v, mask):
    """Dense attention against a fixed-size KV window.

    q [B, S, H, Dh], k/v [B, L, H, Dh], mask [B, S, L] True where the
    query may attend.  Scores and softmax in float32; masked scores are
    -1e30; the output has q's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return o.to(q.dtype)


def write_pages(pool, new, block_table, index, page_aligned: bool = False):
    """Scatter a [B, S, H, Dh] chunk of K or V into the page pool, in
    place; returns ``pool``.

    ``block_table`` [B, M] int32 page ids; ``index`` [B] int32 -- token i
    of row b lands at logical position index[b] + i.  ``page_aligned``
    promises index % page == 0 and S % page == 0 (the prefill-chunk
    case): whole pages are copied instead of token rows.  Positions past
    the table's capacity (M * page) are clamped to the last logical
    slot -- garbage onto garbage by the engine's invariants.  Rows whose
    table is all zeros write into the scratch page."""
    num_pages, page_size, h, dh = pool.shape
    b, s = new.shape[:2]
    m = block_table.shape[1]
    table = block_table.long()
    if page_aligned:
        n_pages = s // page_size
        pstart = index.long() // page_size                        # [B]
        pidx = torch.clamp(
            pstart[:, None] + torch.arange(n_pages, device=pool.device),
            max=m - 1)
        page = torch.gather(table, 1, pidx)                       # [B, n]
        pool[page.reshape(-1)] = new.reshape(
            b * n_pages, page_size, h, dh).to(pool.dtype)
        return pool
    pos = index.long()[:, None] + torch.arange(s, device=pool.device)
    pos = torch.clamp(pos, max=m * page_size - 1)                 # [B, S]
    page = torch.gather(table, 1, pos // page_size)
    flat = page * page_size + pos % page_size                     # [B, S]
    pool.view(num_pages * page_size, h, dh)[flat.reshape(-1)] = new.reshape(
        b * s, h, dh).to(pool.dtype)
    return pool


def gather_pages(pool, block_table):
    """Each row's full logical window: pool [P, page, H, Dh], table
    [B, M] -> [B, M * page, H, Dh], ordered by logical position.
    Unallocated entries gather the scratch page; callers mask them."""
    _, page_size, h, dh = pool.shape
    b, m = block_table.shape
    return pool[block_table.long()].reshape(b, m * page_size, h, dh)


def paged_attention(q, pool_k, pool_v, block_table, index):
    """Attention of S queries per row over the row's paged KV history
    (the gather oracle).  q [B, S, H, Dh] at positions index[b] + i;
    the chunk's own K/V are already in the pool (write-then-attend), so
    query i sees positions j <= index + i."""
    k = gather_pages(pool_k, block_table)
    v = gather_pages(pool_v, block_table)
    s = q.shape[1]
    jpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    qpos = (index.long()[:, None, None]
            + torch.arange(s, device=q.device)[None, :, None])
    return cached_attention(q, k, v, jpos <= qpos)


def paged_flash_decode_reference(q, pool_k, pool_v, block_table, index, *,
                                 scale=None):
    """The kernel's plain version: page-by-page ``bw.block_accumulate``
    in logical order, every page of the table visited, dead pages under
    a fully masked bias (inert: p is exactly 0 and the correction
    exactly 1).  Same contract as :func:`paged_attention`."""
    b, s, h, d = q.shape
    page_size = pool_k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / d ** 0.5
    dev = q.device
    table = block_table.long()
    qh = q.transpose(1, 2)                                    # [B, H, S, D]
    o = torch.zeros(qh.shape, dtype=torch.float32, device=dev)
    m = torch.full((b, h, s), bw.NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    qpos = (index.long()[:, None, None, None]
            + torch.arange(s, device=dev)[None, None, :, None])
    offs = torch.arange(page_size, device=dev)
    for j in range(table.shape[1]):
        k = pool_k[table[:, j]].transpose(1, 2)               # [B, H, P, D]
        v = pool_v[table[:, j]].transpose(1, 2)
        kpos = (j * page_size + offs)[None, None, None, :]
        bias = torch.where(kpos <= qpos, 0.0, bw.NEG_INF).float()
        o, m, l = bw.block_accumulate(o, m, l, qh, k, v, scale, bias)
    return bw.finalize(o, l).to(q.dtype).transpose(1, 2)


def check_kernel_args(q, pool_k, pool_v, block_table, index) -> None:
    """What the kernel accepts; raises ValueError on anything else."""
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name}: kernel takes float32 or bfloat16, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    for name, t in (("block_table", block_table), ("index", index)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
    if not (q.dtype == pool_k.dtype == pool_v.dtype):
        raise ValueError("q and the pools must share one dtype")
    if len({t.device for t in (q, pool_k, pool_v, block_table, index)}) > 1:
        raise ValueError("all operands must be on one device")
    b, _, h, d = q.shape
    if pool_k.shape != pool_v.shape or pool_k.shape[2:] != (h, d):
        raise ValueError(f"pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != b:
        raise ValueError(f"block_table must be [{b}, M], got "
                         f"{tuple(block_table.shape)}")
    if tuple(index.shape) != (b,):
        raise ValueError(f"index must be [{b}], got {tuple(index.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")


def _paged_flash_decode_cuda(q, pool_k, pool_v, block_table, index, scale):
    global launches
    check_kernel_args(q, pool_k, pool_v, block_table, index)
    b, s, h, d = q.shape
    num_pages, page_size = pool_k.shape[:2]
    m_pages = block_table.shape[1]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    kps = KEYS_PER_SPLIT
    # each split's un-normalized f32 o and its (m, l), per query row
    rows = b * h * num_splits(m_pages, page_size, kps) * s
    o_part = torch.empty(rows * d, dtype=torch.float32, device=q.device)
    ml_part = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    fn = _build.load("paged_decode")
    # the stream of the tensors' device, taken in the calling thread
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 block_table.data_ptr(), index.data_ptr(), o.data_ptr(),
                 o_part.data_ptr(), ml_part.data_ptr(), b, s, h, d,
                 num_pages, page_size, m_pages, kps,
                 KERNEL_DTYPES[q.dtype], ctypes.c_float(scale), stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o


def paged_flash_decode(q, pool_k, pool_v, block_table, index, *,
                       scale=None):
    """Attention of a chunk of queries over each row's paged KV history,
    pages read through the block table (same contract as
    :func:`paged_attention`).  CUDA tensors run the kernel; CPU tensors
    its plain version."""
    scale = float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5
    _report_ops(q, block_table, index, pool_k.shape[1])
    if q.is_cuda:
        return _paged_flash_decode_cuda(q, pool_k, pool_v, block_table,
                                        index, scale)
    return paged_flash_decode_reference(q, pool_k, pool_v, block_table,
                                        index, scale=scale)


def paged_attention_auto(q, pool_k, pool_v, block_table, index, *,
                         window_pages=None):
    """The kernel for CUDA tensors, the gather for CPU tensors.
    ``window_pages`` trims the gather's window to the pages the chunk
    can see; the kernel needs no trim (it stops at the live length).
    Inside a ledger count both report K4's operations."""
    if q.is_cuda:
        return paged_flash_decode(q, pool_k, pool_v, block_table, index)
    _report_ops(q, block_table, index, pool_k.shape[1])
    table = (block_table if window_pages is None
             else block_table[:, :window_pages])
    return paged_attention(q, pool_k, pool_v, table, index)
