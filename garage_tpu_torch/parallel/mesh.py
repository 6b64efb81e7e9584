"""Device grids and the split block data-plane steps (ported from the
JAX package's parallel/mesh.py).

The JAX package annotates shardings on a `jax.sharding.Mesh` and lets
XLA partition its jitted steps. Here a grid is a (dp, tp) table of
torch devices and a step is an explicit launch sequence: the input is
cut into one part per grid cell, each part is copied to its cell's
device and runs the port's kernels there (G1 `gf_apply`, G2 `gf_check`,
B3 `blake3_rows`: ops/) on that cell's own CUDA stream, and the parts
are gathered back, in order, onto the caller's device and stream. On
CPU tensors the same wrappers run their plain torch versions.

Shapes:
  stripe batch: (B, k, S) uint8 — B stripes, k data shards, S bytes/shard
  parity:       (B, m, S) uint8
  hashes:       (B, n, 32) uint8 — BLAKE3 of each of the n = k+m shards

Splits: dp must divide B and tp must divide S. The GF work splits the
byte axis over tp (a product is per byte column, so the parts need no
exchange). Hashing takes whole shards: each dp part's shards are
gathered whole, then split over the n = k+m axis across the tp cells
when tp divides n (the whole-shard layout), else hashed on the group's
first cell (RS(10,4) on tp = 4, RS(2,1) on tp = 2). The bytes out equal
the one-device result exactly, whatever the grid.

What differs from the JAX package: the grid holds torch devices and may
repeat one; `make_gf_apply_step` takes the per-stripe COEFFICIENT
matrices (B, rows, k), as the port's `rs.gf_apply_batched` does, not
their bit expansions; the layouts are plain axis tuples.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import torch

from ..ops import gf_kernel, rs, treehash


@dataclass(frozen=True)
class Grid:
    """A (dp, tp) table of torch devices: devices[i][j] is the cell of
    stripe part i and byte part j."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_plane_mesh(n_devices: int | None = None, tp: int | None = None,
                    devices=None) -> Grid:
    """(dp, tp) grid over `devices` (default: every visible CUDA
    device), or the first `n_devices` of them. `devices` may name one
    device several times."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the grid's devices")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devs = [_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a grid needs at least one device")
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if n % tp:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    return Grid(tuple(tuple(devs[i * tp:(i + 1) * tp])
                      for i in range(n // tp)))


def _layouts(grid: Grid, n: int, shard_len: int):
    """(bytes_layout, shards_layout, n_sharded) for a (B, n, S) stripe
    batch, each layout naming the grid axis of each array axis.
    Validates tp | S; splits the n axis in the whole-shard layout only
    when tp | n, else keeps splitting S (see module docstring)."""
    tp = grid.shape["tp"]
    if shard_len % tp:
        raise ValueError(
            f"tp={tp} must divide shard_len={shard_len} (byte-split layout)")
    bytes_layout = ("dp", None, "tp")
    if n % tp == 0:
        return bytes_layout, ("dp", "tp", None), True
    return bytes_layout, bytes_layout, False


# ---------------------------------------------------------------------------
# Running parts on grid cells
# ---------------------------------------------------------------------------

# (grid, i, j) -> the cell's CUDA stream; one per cell, so two cells on
# one device run concurrently
_streams: dict[tuple, torch.cuda.Stream] = {}
_streams_lock = threading.Lock()


def _stream(grid: Grid, i: int, j: int) -> torch.cuda.Stream:
    with _streams_lock:
        s = _streams.get((grid, i, j))
        if s is None:
            s = _streams[(grid, i, j)] = torch.cuda.Stream(
                grid.devices[i][j])
        return s


def _run_cells(grid: Grid, home: torch.device, jobs: list) -> list:
    """Run each job (i, j, fn, args): the args copied to cell (i, j)'s
    device, fn(*args) launched there on the cell's stream after the
    caller's current stream (which wrote the args). -> each job's output
    tensors, on `home` and ordered on the caller's stream."""
    for row in grid.devices:
        for dev in row:
            if dev.type != home.type:
                raise ValueError(f"grid device {dev} and tensors on {home}: "
                                 "a grid holds devices of one type")
    if home.type != "cuda":
        return [fn(*(a.to(grid.devices[i][j]) for a in args))
                for i, j, fn, args in jobs]
    caller = torch.cuda.current_stream(home)
    launched = []
    for i, j, fn, args in jobs:
        s = _stream(grid, i, j)
        s.wait_stream(caller)
        with torch.cuda.stream(s):
            moved = []
            for a in args:
                a.record_stream(s)  # the caller's memory, read on s
                moved.append(a.to(grid.devices[i][j], non_blocking=True))
            launched.append((s, fn(*moved)))
    outs = []
    for s, out in launched:
        caller.wait_stream(s)
        parts = out if isinstance(out, tuple) else (out,)
        for t in parts:
            t.record_stream(caller)  # s's memory, read on the caller's
        moved = tuple(t.to(home, non_blocking=True) for t in parts)
        outs.append(moved if isinstance(out, tuple) else moved[0])
    return outs


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}={parts} must divide {n}")
    return n // parts


def _mat(mat, device: torch.device) -> torch.Tensor:
    """One (r, k) coefficient matrix as a (1, r, k) tensor on `device`
    (cached by value: a runtime operand, never part of a build)."""
    return rs._mat_on(mat.tobytes(), *mat.shape, device)


def _gf_apply(grid: Grid, mats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b] = mats[b or 0] . x[b] over GF(2^8), (B|1, r, k) u8 and
    (B, k, S) u8 -> (B, r, S) u8: one G1 launch per cell on the cell's
    stripe part and byte part."""
    dp, tp = grid.shape["dp"], grid.shape["tp"]
    b, _, s = x.shape
    bp, sp = _split(b, dp, "dp"), _split(s, tp, "tp")
    jobs = [(i, j, gf_kernel.gf_apply,
             (mats if mats.shape[0] == 1 else mats[i * bp:(i + 1) * bp],
              x[i * bp:(i + 1) * bp, :, j * sp:(j + 1) * sp]))
            for i in range(dp) for j in range(tp)]
    outs = _run_cells(grid, x.device, jobs)
    rows = [torch.cat(outs[i * tp:(i + 1) * tp], dim=2) if tp > 1
            else outs[i * tp] for i in range(dp)]
    return torch.cat(rows, dim=0) if dp > 1 else rows[0]


def _hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """(R, S) whole shards -> (R, 32) BLAKE3 digests (one B3 launch)."""
    r, s = rows.shape
    lengths = torch.full((r,), s, dtype=torch.int32, device=rows.device)
    return treehash.hash_rows(rows.contiguous(), lengths)


def _hash_all_shards(grid: Grid, shards: torch.Tensor,
                     n_sharded: bool) -> torch.Tensor:
    """(B, n, S) uint8 -> (B, n, 32) uint8 BLAKE3 digests of the whole
    shards, in the host's byte order: per stripe part one B3 launch over
    its B/dp * n rows on the group's first cell, or over B/dp * n/tp
    rows on each of its cells when the n axis is split."""
    dp, tp = grid.shape["dp"], grid.shape["tp"]
    b, n, s = shards.shape
    bp = _split(b, dp, "dp")
    nt = tp if n_sharded else 1
    npart = n // nt
    jobs = [(i, j, _hash_rows,
             (shards[i * bp:(i + 1) * bp, j * npart:(j + 1) * npart]
              .reshape(bp * npart, s),))
            for i in range(dp) for j in range(nt)]
    outs = _run_cells(grid, shards.device, jobs)
    parts = [o.reshape(bp, npart, 32) for o in outs]
    groups = [torch.cat(parts[i * nt:(i + 1) * nt], dim=1) if nt > 1
              else parts[i] for i in range(dp)]
    return torch.cat(groups, dim=0) if dp > 1 else groups[0]


def _chunked(shard_len: int) -> None:
    if shard_len % treehash.CHUNK_LEN:
        raise ValueError(
            f"shard_len must be a multiple of {treehash.CHUNK_LEN}")


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_put_step(grid: Grid, k: int, m: int, shard_len: int):
    """PUT data plane: (B, k, S) stripes -> (parity (B, m, S), hashes
    (B, n, 32)): G1 per cell on the byte parts, the parity gathered and
    concatenated to the whole (B, n, S) shards, then B3 on the whole
    shards (two launches per cell at most)."""
    _chunked(shard_len)
    pmat = rs.parity_matrix(k, m)
    _, _, n_sharded = _layouts(grid, k + m, shard_len)

    def step(data: torch.Tensor):
        parity = _gf_apply(grid, _mat(pmat, data.device), data)
        allsh = torch.cat([data, parity], dim=1)  # (B, n, S)
        return parity, _hash_all_shards(grid, allsh, n_sharded)

    return step


@functools.lru_cache(maxsize=None)
def make_encode_step(grid: Grid, k: int, m: int, shard_len: int):
    """Parity-only encode: (B, k, S) data -> (B, m, S) parity, one G1
    launch per cell (stripe part x byte part). The feeder's multi-device
    route for encode and encode_put: the live PUT path hashes on its own
    lane, so this step skips the hashing of make_put_step."""
    pmat = rs.parity_matrix(k, m)
    _layouts(grid, k + m, shard_len)

    def step(data: torch.Tensor) -> torch.Tensor:
        return _gf_apply(grid, _mat(pmat, data.device), data)

    return step


@functools.lru_cache(maxsize=None)
def make_parity_check_step(grid: Grid, k: int, m: int, shard_len: int):
    """Per-stripe parity consistency: (B, k+m, S) stored shards -> (B,)
    bool, True when re-derived parity equals the stored parity rows: one
    G2 launch per cell on its byte part, the verdicts of a stripe's byte
    parts ANDed. The deep scrub's multi-device route; zero-padded
    stripes come out True (the code is linear) and are sliced away by
    the caller."""
    pmat = rs.parity_matrix(k, m)
    _layouts(grid, k + m, shard_len)
    dp, tp = grid.shape["dp"], grid.shape["tp"]

    def step(stripes: torch.Tensor) -> torch.Tensor:
        b, _, s = stripes.shape
        bp, sp = _split(b, dp, "dp"), _split(s, tp, "tp")
        mats = _mat(pmat, stripes.device)
        jobs = [(i, j, gf_kernel.gf_check,
                 (mats, stripes[i * bp:(i + 1) * bp, :, j * sp:(j + 1) * sp]))
                for i in range(dp) for j in range(tp)]
        outs = _run_cells(grid, stripes.device, jobs)
        ok = torch.stack(outs).reshape(dp, tp, bp).all(dim=1)
        return ok.reshape(b)

    return step


@functools.lru_cache(maxsize=None)
def make_gf_apply_step(grid: Grid, k: int, rows: int, shard_len: int):
    """Pattern-as-data GF apply: per-stripe (B, rows, k) coefficient
    matrices applied to a (B, k, S) shard stack -> (B, rows, S), one G1
    launch per cell (the matrices split with the stripes, whole on every
    byte part). The feeder's multi-device decode and repair route: one
    step per SHAPE serves every erasure pattern, because which shards
    survived lives in the matrix data."""
    tp = grid.shape["tp"]
    if shard_len % tp:
        raise ValueError(
            f"tp={tp} must divide shard_len={shard_len} (byte-split layout)")

    def step(mats: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
        if tuple(mats.shape[1:]) != (rows, k):
            raise ValueError(f"matrices {tuple(mats.shape)} are not "
                             f"(B, {rows}, {k})")
        return _gf_apply(grid, mats, shards)

    return step


@functools.lru_cache(maxsize=None)
def make_scrub_step(grid: Grid, k: int, m: int, shard_len: int):
    """Scrub: verify every stored shard's hash and the parity.

    (B, n, S) shards + (B, n, 32) expected hashes -> (per-shard corrupt
    mask (B, n) bool, corrupt total int32). B3 on the whole shards, G1
    re-deriving the parity on the byte parts; a parity row counts as
    corrupt only when every data shard of its stripe hash-checks (a
    corrupt data shard changes every re-derived parity row, which would
    smear one bad data shard over m healthy parity shards)."""
    _chunked(shard_len)
    pmat = rs.parity_matrix(k, m)
    _, _, n_sharded = _layouts(grid, k + m, shard_len)

    def step(shards: torch.Tensor, expected_hashes: torch.Tensor):
        hashes = _hash_all_shards(grid, shards, n_sharded)
        hash_bad = (hashes != expected_hashes).any(dim=-1)  # (B, n)
        parity2 = _gf_apply(grid, _mat(pmat, shards.device),
                            shards[:, :k, :])
        data_clean = ~hash_bad[:, :k].any(dim=1)  # (B,)
        parity_bad = (parity2 != shards[:, k:, :]).any(dim=-1) \
            & data_clean[:, None]  # (B, m)
        bad = hash_bad | torch.cat(
            [torch.zeros_like(hash_bad[:, :k]), parity_bad], dim=1)
        return bad, bad.sum(dtype=torch.int32)

    return step


@functools.lru_cache(maxsize=None)
def _repair_apply_step(grid: Grid, n: int, shard_len: int):
    """Shape-keyed inner step of make_repair_step: (matrix (1, r, k),
    surviving (B, k, S)) -> (rebuilt (B, r, S), hashes (B, r, 32)).
    Keyed on grid and shape only, never on the erasure pattern: the
    repair matrix is a runtime operand of G1."""
    _layouts(grid, n, shard_len)

    def step(mat: torch.Tensor, surviving: torch.Tensor):
        rebuilt = _gf_apply(grid, mat, surviving)
        _, _, split_r = _layouts(grid, rebuilt.shape[1], shard_len)
        return rebuilt, _hash_all_shards(grid, rebuilt, split_r)

    return step


def make_repair_step(grid: Grid, k: int, m: int, present: tuple[int, ...],
                     missing: tuple[int, ...], shard_len: int):
    """Repair: rebuild the `missing` shards from the k `present` ones
    ((B, k, S), rows in ascending index order) and return them with
    fresh hashes. The pattern's repair matrix rides as a tensor operand
    into the shape-keyed apply, so every pattern of one size shares one
    step object (and the one G1 build)."""
    _chunked(shard_len)
    mat = rs.repair_matrix(k, m, tuple(present), tuple(missing))
    apply_step = _repair_apply_step(grid, k + m, shard_len)

    def step(surviving: torch.Tensor):
        return apply_step(_mat(mat, surviving.device), surviving)

    return step
