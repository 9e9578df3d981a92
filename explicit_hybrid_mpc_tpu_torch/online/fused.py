"""Fused serving evaluation over arena buffers: clamp -> locate ->
evaluate in one launch per mixed-tenant micro-batch.

The CUDA kernel (csrc/arena_eval.cu) and its plain torch version, the
counterpart of the JAX package's fused Pallas kernel
(online/pallas_eval.py ``_fused_kernel`` / ``arena_eval_fused``) and of
its XLA twin ``arena_eval_xla``.  For each query row b, with
homogeneous query th1[b], certified box lb1[b]/ub1[b] and column
extent [s_b, e_b):

- thc = min(max(th1, lb1), ub1), clamped = any(th1 != thc);
- score[c] = min_i sum_j thc[j] * bary[i, j, c] for c in [s_b, e_b),
  in float32; the FIRST column with the largest score wins, columns
  outside the extent never do (a row with an empty extent gets score
  -1e30 at column 0, as ``arena_eval_xla`` gives);
- at the winner c*: u[n] = sum_i lam_i U[i, c*, n] and
  cost = sum_i lam_i V[i, c*].

A query with a NaN coordinate stays NaN through the clamp (clamped),
scores NaN in every column, and a NaN score counts as the largest (the
``argmax`` order of torch and of ``arena_eval_xla``): the row gets val
NaN at the first column of its extent, so it is never served.

Buffer layout (serve/arena.py keeps them resident): ``bary`` (p+1,
p+1, C), ``U`` (p+1, C, n_u), ``V`` (p+1, C), all float32 -- the
``pack_columns`` layout with its TPU padding cut away (vertex rows PV
and contraction width K padded to 8, control lanes NU to 128): on CUDA
the kernel is instantiated per p+1 and masks by extent, so neither pad
rows nor sentinel columns are needed.  Queries come as ONE (3, B, p+1)
float32 tensor [th1; lb1; ub1] and extents as (B, 2) int32 absolute
columns.

The CUDA kernel also takes a launch plan (``plan_batch``, built on the
host where the CPU tests reach it): the rows ordered by extent and cut
into tiles of at most ``TILE_ROWS`` rows of one extent, and the number
of column chunks each tile's extent is split into, one block each, so
that a small batch still fills the card.  A row's record does not
depend on the plan.

Results come back as ONE (B, 4 + n_u) int32 record tensor, so a batch
costs one device->host copy: per row [val (f32 bits), col, cost (f32
bits), clamped (0/1), u[0..n_u) (f32 bits)]; ``unpack`` views it as
(val, col, u, cost, clamped).

A CUDA tensor launches the kernel (and raises ``kernels.KernelError``
when it cannot -- there is no fallback); a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import kernels

#: Launches of the CUDA kernel.  A plain counter; chip_smoke.py zeroes
#: it before the serving run and reads it after.
launches = 0

#: Largest p + 1 the kernel is instantiated for.
MAX_K = 8

#: Score of a masked column (and of a row with an empty extent).
_BIG = 1e30

#: Padded control-input width of the JAX arena's U buffer (the TPU lane
#: width); ``pack_columns`` keeps it as its default so that its output
#: is bitwise the JAX package's.
_NU = 128

#: Leading int32 words of a result record, before the n_u inputs.
REC_HEAD = 4

#: Elements of the plain version's (chunk, p+1, C) score tensor.
_CHUNK_ELEMS = 1 << 26

#: Launch plan of the CUDA kernel: the most rows of one extent per block,
#: the int32 words of a tile ({rows, start, end, unused, row ids}) and the
#: most column chunks of a tile (csrc/arena_eval.cu kTileRows,
#: kTileWords, kMaxChunks; _lib checks them), the fewest columns of a
#: chunk (four per thread of a 128-thread block: one batch of loads), and
#: the most blocks per SM a plan makes.
TILE_ROWS = 8
TILE_WORDS = 4 + TILE_ROWS
MAX_CHUNKS = 64
MIN_CHUNK_COLS = 512
BLOCKS_PER_SM = 4

#: Tiles a plan aims at: a tile takes B // TILE_AIM rows, at least 2 and
#: at most TILE_ROWS (measured on the H100: a 16- or 64-row serving batch
#: runs fastest in 2-row tiles, 256 rows in 4-row tiles, and a tile's rows
#: share its column loads, which large batches need).
TILE_AIM = 64

class Plan(NamedTuple):
    """A launch plan on the kernel's device, for a batch of ``rows``
    rows: ``chunks`` column chunks per tile and ``tiles`` (n_tiles,
    TILE_WORDS) int32, each {n, start, end, 0, n row ids}: n <=
    TILE_ROWS rows of the batch that share the extent [start, end).
    The kernel reads each row's extent from its tile, so a plan is
    ``plan_batch``'s over the batch's own extents (``make_plan``, or
    serve/arena.py's ``pack_queries``, which packs both from one host
    array)."""

    chunks: int
    tiles: torch.Tensor
    rows: int


def plan_batch(ext: np.ndarray, n_sm: int = device_lib.DEFAULT_SMS
               ) -> tuple[int, np.ndarray]:
    """Host side of a launch plan for (B, 2) extents: (chunks, tiles
    (n_tiles, TILE_WORDS) int32).  Rows are ordered by extent (then by
    row) and every run of rows with one extent is cut into tiles of at
    most B // TILE_AIM rows (2 to TILE_ROWS); the chunk count makes no
    more than BLOCKS_PER_SM blocks per SM, no chunk under MIN_CHUNK_COLS
    columns of the widest extent and at most MAX_CHUNKS."""
    ext = np.asarray(ext, dtype=np.int64).reshape(-1, 2)
    B = ext.shape[0]
    if B == 0:
        return 1, np.zeros((0, TILE_WORDS), np.int32)
    perm = np.lexsort((np.arange(B), ext[:, 1], ext[:, 0]))
    se = ext[perm]
    run = np.flatnonzero(np.concatenate(
        ([True], (se[1:] != se[:-1]).any(axis=1))))
    run_end = np.append(run[1:], B)
    rows = min(TILE_ROWS, max(2, B // TILE_AIM))
    per_run = -(-(run_end - run) // rows)
    first = np.repeat(np.cumsum(per_run) - per_run, per_run)
    lo = np.repeat(run, per_run) + rows * (np.arange(per_run.sum()) - first)
    hi = np.minimum(lo + rows, np.repeat(run_end, per_run))
    tiles = np.zeros((len(lo), TILE_WORDS), dtype=np.int32)
    tiles[:, 0] = hi - lo
    tiles[:, 1:3] = se[lo]
    at = lo[:, None] + np.arange(TILE_ROWS)
    tiles[:, 4:] = np.where(at < hi[:, None],
                            perm[np.minimum(at, B - 1)], 0)
    widest = int(np.maximum(tiles[:, 2] - tiles[:, 1], 0).max())
    chunks = min(MAX_CHUNKS,
                 max(1, BLOCKS_PER_SM * n_sm // len(tiles)),
                 max(1, -(-widest // MIN_CHUNK_COLS)))
    return chunks, tiles


def make_plan(ext: np.ndarray, device) -> Plan:
    """``plan_batch``'s plan for host (B, 2) extents, on `device`."""
    device = torch.device(device)
    ext = np.asarray(ext).reshape(-1, 2)
    chunks, tiles = plan_batch(ext, device_lib.sm_count(device))
    return Plan(chunks, torch.as_tensor(tiles).to(device), len(ext))


def chunk_bounds(start: int, end: int, chunks: int, C: int
                 ) -> list[tuple[int, int]]:
    """The column ranges of a tile's chunks, as the kernel cuts them: the
    extent clipped to [0, C), then ``len * g // chunks`` for g = 0 ..
    chunks."""
    s = max(start, 0)
    n = max(min(end, C) - s, 0)
    return [(s + n * g // chunks, s + n * (g + 1) // chunks)
            for g in range(chunks)]


class Scratch:
    """The kernel's resident scratch on one device: per-tile counters,
    which every launch leaves at 0 (so they are zeroed once, when
    allocated), and the chunks' partials.  Launches that share a
    Scratch must be ordered, as launches on one stream are.  Not
    thread-safe: its owner (serve/arena.py DeviceArena) takes it under
    its lock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.counters = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.partials = torch.empty(0, dtype=torch.int32, device=self.device)

    def take(self, n_tiles: int, chunks: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """(counters, partials) large enough for one launch."""
        if self.counters.numel() < n_tiles:
            self.counters = torch.zeros(max(n_tiles, 2 * self.counters.numel()),
                                        dtype=torch.int32, device=self.device)
        words = 2 * n_tiles * TILE_ROWS * chunks
        if self.partials.numel() < words:
            self.partials = torch.empty(max(words, 2 * self.partials.numel()),
                                        dtype=torch.int32, device=self.device)
        return self.counters, self.partials


def pack_columns(table, n_cols: int, PV: int, K: int,
                 nu: int = _NU) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a LeafTable into ``n_cols`` arena columns (host-side, f32).

    Returns (bary (PV, K, n_cols), U (PV, n_cols, nu), V (PV, n_cols)),
    bitwise the JAX package's ``pallas_eval.pack_columns``: padded
    vertices carry +_BIG at the homogeneous column with zero U/V rows,
    pad columns past the table's leaves carry -_BIG.  The f64 -> f32
    cast is elementwise, so packing rows gathered from an existing
    extent is bitwise identical to packing from the f64 table -- the
    property delta publishes into the arena rely on."""
    L, pp1, _ = table.bary_M.shape
    p = pp1 - 1
    if L > n_cols:
        raise ValueError(f"table has {L} leaves > {n_cols} columns")
    if table.U.shape[2] > nu:
        raise ValueError(f"n_u={table.U.shape[2]} exceeds arena lane pad {nu}")
    bary = np.zeros((PV, K, n_cols), dtype=np.float32)
    bary[:pp1, :pp1, :L] = np.ascontiguousarray(
        table.bary_M.transpose(1, 2, 0), dtype=np.float32)
    bary[pp1:, p, :L] = _BIG
    bary[:, p, L:] = -_BIG
    U = np.zeros((PV, n_cols, nu), dtype=np.float32)
    U[:pp1, :L, :table.U.shape[2]] = np.ascontiguousarray(
        table.U.transpose(1, 0, 2), dtype=np.float32)
    V = np.zeros((PV, n_cols), dtype=np.float32)
    V[:pp1, :L] = np.ascontiguousarray(table.V.T, dtype=np.float32)
    return bary, U, V


def split_queries(buf: torch.Tensor, B: int, pp1: int):
    """One int32 buffer (serve/arena.py ``pack_queries``) -> the (3, B,
    p+1) float32 query planes, the (B, 2) int32 extents and the plan's
    (n_tiles, TILE_WORDS) tiles, as views."""
    nq = 3 * B * pp1
    return (buf[:nq].view(torch.float32).view(3, B, pp1),
            buf[nq:nq + 2 * B].view(B, 2),
            buf[nq + 2 * B:].view(-1, TILE_WORDS))


def unpack(rec: torch.Tensor):
    """(B, 4 + n_u) int32 records -> (val f32, col i32, u (B, n_u) f32,
    cost f32, clamped bool), as views (clamped excepted)."""
    return (rec[:, 0].view(torch.float32), rec[:, 1],
            rec[:, REC_HEAD:].view(torch.float32),
            rec[:, 2].view(torch.float32), rec[:, 3] != 0)


def _check(bary, U, V, q, ext) -> tuple[int, int, int]:
    pp1, pp1b, C = bary.shape
    B = q.shape[1]
    if pp1 != pp1b or U.shape[:2] != (pp1, C) or U.dim() != 3 \
            or tuple(V.shape) != (pp1, C):
        raise ValueError("arena_eval: buffers must be bary (p+1, p+1, C), "
                         "U (p+1, C, n_u), V (p+1, C)")
    if tuple(q.shape) != (3, B, pp1) or tuple(ext.shape) != (B, 2):
        raise ValueError("arena_eval: q must be (3, B, p+1) and ext (B, 2)")
    for t in (bary, U, V, q):
        if t.dtype != torch.float32:
            raise TypeError("arena_eval: buffers and queries are float32")
    if ext.dtype != torch.int32:
        raise TypeError("arena_eval: ext is int32")
    devs = {t.device for t in (bary, U, V, q, ext)}
    if len(devs) != 1:
        raise ValueError(f"arena_eval: tensors on several devices {devs}")
    return pp1, C, B


# tpulint: device-region
def arena_eval_torch(bary: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                     q: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """Plain version, on the tensors' device: the semantics of the JAX
    package's ``arena_eval_xla`` (one float32 product over the live
    vertex rows of every column, min over vertices, extent mask,
    first-match argmax, gather of u/cost at the winner), in row chunks
    so the (rows, p+1, C) score tensor stays bounded.  Returns the
    (B, 4 + n_u) int32 records."""
    pp1, C, B = _check(bary, U, V, q, ext)
    th1, lb1, ub1 = q[0], q[1], q[2]
    thc = torch.minimum(torch.maximum(th1, lb1), ub1)
    clamped = (th1 != thc).any(dim=1)
    col = torch.arange(C, dtype=torch.int32, device=q.device)
    chunk = max(1, _CHUNK_ELEMS // max(1, pp1 * C))
    flat = bary.permute(1, 0, 2).reshape(pp1, pp1 * C)
    vals, bests, lams = [], [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, B, chunk):
            lam = torch.matmul(thc[lo:lo + chunk], flat).reshape(-1, pp1, C)
            e = ext[lo:lo + chunk]
            live = (col[None, :] >= e[:, 0:1]) & (col[None, :] < e[:, 1:2])
            score = torch.where(live, lam.amin(dim=1),
                                torch.full((), -_BIG, dtype=torch.float32,
                                           device=q.device))
            best = torch.argmax(score, dim=1)            # first maximum
            vals.append(torch.gather(score, 1, best[:, None])[:, 0])
            bests.append(best)
            lams.append(torch.gather(
                lam, 2, best[:, None, None].expand(-1, pp1, 1))[:, :, 0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    best = torch.cat(bests)
    lam_best = torch.cat(lams)                           # (B, p+1)
    u = torch.einsum("bi,bin->bn", lam_best, U[:, best, :].transpose(0, 1))
    cost = torch.sum(lam_best * V[:, best].T, dim=1)
    return torch.cat([torch.cat(vals).view(torch.int32)[:, None],
                      best.to(torch.int32)[:, None],
                      cost.view(torch.int32)[:, None],
                      clamped.to(torch.int32)[:, None],
                      u.contiguous().view(torch.int32)], dim=1)


def _lib():
    lib = kernels.library("arena_eval")
    if not getattr(lib, "_ehm_typed", False):
        lib.arena_eval_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.arena_eval_f32.restype = ctypes.c_int
        lib.arena_eval_error_string.argtypes = [ctypes.c_int]
        lib.arena_eval_error_string.restype = ctypes.c_char_p
        if (lib.arena_eval_tile_rows(), lib.arena_eval_max_chunks()) != \
                (TILE_ROWS, MAX_CHUNKS):
            raise kernels.KernelError(
                "arena_eval: the kernel's tile rows and chunk limit differ "
                "from the launch plan's TILE_ROWS and MAX_CHUNKS")
        lib._ehm_typed = True
    return lib


# tpulint: device-region
def arena_eval_cuda(bary: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                    q: torch.Tensor, ext: torch.Tensor, plan: Plan,
                    scratch: Scratch) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream, with the launch
    `plan` of these extents and the kernel's `scratch` on the same
    device; raises on anything it does not take (ValueError/TypeError)
    and on a failed build or launch (kernels.KernelError).  Does not
    synchronize.  The kernel skips a tile's row id outside [0, B), so a
    wrong plan cannot write outside the records.  Returns the (B, 4 +
    n_u) int32 records, in the rows' order."""
    pp1, C, B = _check(bary, U, V, q, ext)
    dev = bary.device
    if dev.type != "cuda":
        raise ValueError("arena_eval_cuda: tensors must be on a CUDA device")
    if not all(t.is_contiguous() for t in (bary, U, V, q, ext)):
        raise ValueError("arena_eval_cuda: tensors must be contiguous")
    if not 2 <= pp1 <= MAX_K:
        raise ValueError(f"arena_eval: p+1={pp1} outside the kernel's "
                         f"2..{MAX_K}")
    n_u = U.shape[2]
    rec = torch.empty((B, REC_HEAD + n_u), dtype=torch.int32, device=dev)
    if B == 0:
        return rec
    if C == 0:
        raise ValueError("arena_eval: the arena has no columns")
    chunks, tiles, rows = plan
    if rows != B:
        raise ValueError(f"arena_eval: a plan for {rows} rows, a batch of "
                         f"{B}")
    if tiles.dim() != 2 or tiles.shape[1] != TILE_WORDS or not \
            1 <= tiles.shape[0] <= B or not 1 <= chunks <= MAX_CHUNKS:
        raise ValueError(f"arena_eval: the plan must hold 1..B tiles (n, "
                         f"{TILE_WORDS}) and 1..{MAX_CHUNKS} chunks")
    if tiles.dtype != torch.int32 or tiles.device != dev or \
            not tiles.is_contiguous():
        raise ValueError("arena_eval: the plan's tiles must be contiguous "
                         "int32 on the buffers' device")
    if scratch.device != dev:
        raise ValueError("arena_eval: the scratch is on another device")
    n_tiles = tiles.shape[0]
    counters = partials = None
    if chunks > 1:
        counters, partials = scratch.take(n_tiles, chunks)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arena_eval_f32(
            q.data_ptr(), tiles.data_ptr(), n_tiles, chunks,
            bary.data_ptr(), U.data_ptr(), V.data_ptr(), B, C, pp1 - 1, n_u,
            None if counters is None else counters.data_ptr(),
            None if partials is None else partials.data_ptr(),
            rec.data_ptr(), stream)
    if err != 0:
        raise kernels.KernelError(
            "arena_eval: CUDA launch failed: "
            + lib.arena_eval_error_string(err).decode())
    global launches
    launches += 1
    return rec


def arena_eval(bary: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
               q: torch.Tensor, ext: torch.Tensor,  # tpulint: device-region
               plan: Optional[Plan] = None,
               scratch: Optional[Scratch] = None) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors (with `plan` and `scratch`), the
    plain version for CPU ones (which needs neither); (B, 4 + n_u) int32
    records either way."""
    if bary.device.type == "cuda":
        if plan is None or scratch is None:
            raise ValueError("arena_eval: a CUDA launch takes a plan and "
                             "scratch")
        return arena_eval_cuda(bary, U, V, q, ext, plan, scratch)
    if bary.device.type != "cpu":
        raise ValueError(f"arena_eval: unsupported device {bary.device}")
    return arena_eval_torch(bary, U, V, q, ext)
