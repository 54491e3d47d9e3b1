"""Process grid and stage-wise layouts of the sharded ParaDiag pipeline.

The counterpart of ``optimal_control_paradiag_tpu/parallel/sharding.py``.
The all-at-once state ``(2, L, N)`` (L time slices or spectral modes, N
spatial unknowns) passes through three stages, each with its own block
layout over a ('time', 'space') grid of ``P = n_time * n_space`` ranks:

- **canonical**: L split over the grid's time axis, N over its space axis;
  Krylov vectors and the matrix-free operator live here;
- **time_local**: every time slice (or mode) local, N split over all P
  ranks; the time transforms run here;
- **mode_local**: L split over all P ranks, N local; the spatial transform
  and the per-mode solves run here.

In JAX, XLA places the collectives behind ``with_sharding_constraint``.
Here every rank holds only its own block, so each stage transition is one
``all_to_all_single`` over the grid's group that the layout issues itself
(:meth:`ParallelLayout.move`), each inner product of a Krylov loop is an
``all_reduce`` (:meth:`ParallelLayout.all_reduce`), and the stencil halos are
``batch_isend_irecv`` exchanges (:meth:`ParallelLayout.apply_stencil`).

Blocks follow ``np.array_split``: an axis of length L over p parts gives the
first ``L % p`` parts one row more. Uneven shapes therefore need no padding,
and no padded entry can reach a reduction. A layout counts every collective
it issues by kind (:attr:`ParallelLayout.counts`): the port's counterpart of
the JAX tests' reading of the compiled program (its all-gathers). A layout on
a 1x1 grid still issues its stage moves and reductions; a halo along an
axis that one rank holds whole posts no exchange, so a 1x1 grid issues no
``batch_isend_irecv``. Only :class:`IdentityLayout`, the stand-in for
``layout=None``, is free; every builder resolves ``layout=None`` to it
(:func:`resolve_layout`) and branches on ``sharded``.

Complex tensors travel as their ``torch.view_as_real`` float planes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

STAGES = ("canonical", "time_local", "mode_local")


def blocks(length: int, parts: int) -> List[Tuple[int, int]]:
    """``(start, stop)`` of each of ``parts`` blocks of ``range(length)``,
    as ``np.array_split`` cuts it."""
    base, extra = divmod(length, parts)
    out, start = [], 0
    for q in range(parts):
        stop = start + base + (1 if q < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def _as_real(x: torch.Tensor) -> torch.Tensor:
    """A real tensor with a trailing plane axis: ``view_as_real`` of a complex
    tensor, a size-1 axis on a real one."""
    return torch.view_as_real(x) if x.is_complex() else x.unsqueeze(-1)


def _from_real(y: torch.Tensor, complex_: bool) -> torch.Tensor:
    return torch.view_as_complex(y) if complex_ else y.squeeze(-1)


@dataclasses.dataclass(eq=False)
class DeviceMesh:
    """A ('time', 'space') grid of processes. Rank ``ranks[q]`` (a rank of
    the default group) holds grid position ``q = ti * n_space + si``.
    ``index`` is this process's position, None when it is not in the grid.
    ``time_groups[si]`` joins the ranks of grid column ``si``,
    ``space_groups[ti]`` those of grid row ``ti``."""

    n_time: int
    n_space: int
    ranks: Tuple[int, ...]
    group: object
    time_groups: Tuple[object, ...]
    space_groups: Tuple[object, ...]
    index: Optional[int]
    device: torch.device

    @property
    def size(self) -> int:
        return self.n_time * self.n_space

    @property
    def axis_names(self) -> Tuple[str, str]:
        return ("time", "space")


_MESHES: Dict[tuple, tuple] = {}


def _default_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_time: int, n_space: int = 1, group=None) -> DeviceMesh:
    """The ('time', 'space') grid over the first ``n_time * n_space`` ranks
    of ``group`` (the default group when None). Raises ``ValueError`` when
    the group is smaller. Collective: every rank of the default group calls
    it, in the same order, because it makes the grid's process groups
    (``torch.distributed.new_group``); ranks outside the grid get a mesh
    whose ``index`` is None. Grids are made once per shape and group."""
    if n_time < 1 or n_space < 1:
        raise ValueError(f"grid axes must be positive, got ({n_time}, {n_space})")
    need = n_time * n_space
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(f"need {need} devices, have 1")
        raise RuntimeError(
            "no process group: call parallel.multihost.initialize() (or "
            "torch.distributed.init_process_group) before making a mesh"
        )
    base = dist.get_process_group_ranks(group) if group is not None else list(range(dist.get_world_size()))
    if len(base) < need:
        raise ValueError(f"need {need} devices, have {len(base)}")
    whole = dist.group.WORLD if group is None else group
    # keyed by the group object (kept alive by the entry): a new default
    # group after destroy_process_group makes its own grids
    key = (id(whole), n_time, n_space)
    if key in _MESHES:
        return _MESHES[key][0]
    ranks = tuple(base[:need])
    grid = whole if need == len(base) else dist.new_group(list(ranks))
    cols = [[ranks[ti * n_space + si] for ti in range(n_time)] for si in range(n_space)]
    rows = [[ranks[ti * n_space + si] for si in range(n_space)] for ti in range(n_time)]
    time_groups = tuple(grid if n_space == 1 else dist.new_group(c) for c in cols)
    space_groups = tuple(grid if n_time == 1 else dist.new_group(r) for r in rows)
    me = dist.get_rank()
    mesh = DeviceMesh(
        n_time=n_time,
        n_space=n_space,
        ranks=ranks,
        group=grid,
        time_groups=time_groups,
        space_groups=space_groups,
        index=ranks.index(me) if me in ranks else None,
        device=_default_device(whole),
    )
    _MESHES[key] = (mesh, whole)
    return mesh


class ParallelLayout:
    """Stage layouts and the collectives between them on a
    :class:`DeviceMesh` (module docstring). Every method that communicates
    is collective over the grid: each of its ranks calls it with the same
    global extents ``(L, N)`` of the last two axes."""

    sharded = True

    def __init__(self, mesh: DeviceMesh):
        if mesh.index is None:
            raise ValueError("this process is not in the mesh; only its ranks may build a layout")
        self.mesh = mesh
        self.counts: collections.Counter = collections.Counter()

    # ------------------------------------------------------------ geometry

    @property
    def n_time(self) -> int:
        return self.mesh.n_time

    @property
    def n_space(self) -> int:
        return self.mesh.n_space

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def index(self) -> int:
        return self.mesh.index

    @property
    def ti(self) -> int:
        return self.mesh.index // self.mesh.n_space

    @property
    def si(self) -> int:
        return self.mesh.index % self.mesh.n_space

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def box(self, stage: str, L: int, N: int, index: Optional[int] = None) -> Tuple[int, int, int, int]:
        """``(l0, l1, n0, n1)``: the block of grid position ``index`` (this
        rank's by default) of an ``(L, N)`` plane in ``stage``."""
        q = self.index if index is None else index
        nt, ns = self.n_time, self.n_space
        if stage == "canonical":
            (l0, l1), (n0, n1) = blocks(L, nt)[q // ns], blocks(N, ns)[q % ns]
        elif stage == "time_local":
            (l0, l1), (n0, n1) = (0, L), blocks(N, nt * ns)[q]
        elif stage == "mode_local":
            (l0, l1), (n0, n1) = blocks(L, nt * ns)[q], (0, N)
        else:
            raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")
        return l0, l1, n0, n1

    def rows(self, stage: str, L: int) -> slice:
        """This rank's rows (time slices or modes) of an L-row plane in
        ``stage``: what it cuts per-mode constants to."""
        l0, l1, _, _ = self.box(stage, L, 1)
        return slice(l0, l1)

    def scatter(self, x: torch.Tensor, stage: str = "canonical") -> torch.Tensor:
        """This rank's block of a global state ``(..., L, N)`` that every
        rank holds (no communication)."""
        l0, l1, n0, n1 = self.box(stage, x.shape[-2], x.shape[-1])
        return x[..., l0:l1, n0:n1]

    # --------------------------------------------------------- collectives

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or its maximum, ``op='max'``) over the grid; a new
        tensor, complex ones reduced as their real planes."""
        out = t.contiguous().clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(torch.view_as_real(out) if out.is_complex() else out, op=red, group=self.mesh.group)
        self.counts["all_reduce"] += 1
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` on every rank with grid position ``src``'s (set-up
        data that every rank must hold alike); returns ``t``."""
        buf = torch.view_as_real(t) if t.is_complex() else t
        dist.broadcast(buf, self.mesh.ranks[src], group=self.mesh.group)
        self.counts["broadcast"] += 1
        return t

    def move(self, x: torch.Tensor, src: str, dst: str, L: int, N: int) -> torch.Tensor:
        """The ``src``-stage block ``(..., l, n)`` of an ``(..., L, N)`` state
        as its ``dst``-stage block: one ``all_to_all_single`` over the grid,
        each rank sending every other rank the intersection of its block
        with theirs (uneven split sizes; empty parts send nothing)."""
        if src == dst:
            return x
        l0, l1, n0, n1 = self.box(src, L, N)
        if tuple(x.shape[-2:]) != (l1 - l0, n1 - n0):
            raise ValueError(f"{src} block of ({L}, {N}) has shape {(l1 - l0, n1 - n0)}, got {tuple(x.shape[-2:])}")
        xr = _as_real(x)
        lead, planes = tuple(x.shape[:-2]), xr.shape[-1]
        unit = int(np.prod(lead, dtype=np.int64)) * planes
        m0, m1, k0, k1 = self.box(dst, L, N)
        send, in_sizes, recv_boxes, out_sizes = [], [], [], []
        for q in range(self.size):
            a0, a1, b0, b1 = self.box(dst, L, N, q)
            r0, r1, c0, c1 = max(l0, a0), min(l1, a1), max(n0, b0), min(n1, b1)
            if r0 < r1 and c0 < c1:
                send.append(xr[..., r0 - l0 : r1 - l0, c0 - n0 : c1 - n0, :].reshape(-1))
                in_sizes.append((r1 - r0) * (c1 - c0) * unit)
            else:
                in_sizes.append(0)
            a0, a1, b0, b1 = self.box(src, L, N, q)
            r0, r1, c0, c1 = max(m0, a0), min(m1, a1), max(k0, b0), min(k1, b1)
            if r0 < r1 and c0 < c1:
                recv_boxes.append((r0, r1, c0, c1))
                out_sizes.append((r1 - r0) * (c1 - c0) * unit)
            else:
                recv_boxes.append(None)
                out_sizes.append(0)
        inp = torch.cat(send) if send else xr.new_empty(0)
        out = xr.new_empty(sum(out_sizes))
        dist.all_to_all_single(out, inp, out_sizes, in_sizes, group=self.mesh.group)
        self.counts["all_to_all"] += 1
        y = xr.new_empty(lead + (m1 - m0, k1 - k0, planes))
        for piece, rb in zip(torch.split(out, out_sizes), recv_boxes):
            if rb is not None:
                r0, r1, c0, c1 = rb
                y[..., r0 - m0 : r1 - m0, c0 - k0 : c1 - k0, :] = piece.view(lead + (r1 - r0, c1 - c0, planes))
        return _from_real(y, x.is_complex())

    def gather(self, x: torch.Tensor, L: int, N: int, stage: str = "canonical") -> torch.Tensor:
        """The global ``(..., L, N)`` state on every rank from its ``stage``
        blocks: one ``all_gather`` of the blocks padded to a common size."""
        boxes = [self.box(stage, L, N, q) for q in range(self.size)]
        lmax = max(b[1] - b[0] for b in boxes)
        nmax = max(b[3] - b[2] for b in boxes)
        xr = _as_real(x)
        lead, planes = tuple(x.shape[:-2]), xr.shape[-1]
        pad = xr.new_zeros(lead + (lmax, nmax, planes))
        pad[..., : xr.shape[-3], : xr.shape[-2], :] = xr
        parts = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(parts, pad, group=self.mesh.group)
        self.counts["all_gather"] += 1
        y = xr.new_empty(lead + (L, N, planes))
        for (l0, l1, n0, n1), part in zip(boxes, parts):
            y[..., l0:l1, n0:n1, :] = part[..., : l1 - l0, : n1 - n0, :]
        return _from_real(y, x.is_complex())

    def _chain_halo(self, x, dim, bounds, chain, pos, before, after, group):
        """``x`` (this chain position's block along ``dim`` of a partition
        ``bounds`` over the ranks ``chain``) extended by the ``before``
        entries that precede it and the ``after`` entries that follow it
        globally, zeros past either end, by one ``batch_isend_irecv``."""
        dim = dim % x.ndim
        s0, s1 = bounds[pos]
        L = bounds[-1][1]
        need = ((max(0, s0 - before), s0), (s1, min(L, s1 + after)))
        got: Tuple[list, list] = ([], [])
        ops = []
        for q, (a, b) in enumerate(bounds):
            if q == pos:
                continue
            for tag, ((n0, n1), pieces) in enumerate(zip(need, got)):
                i0, i1 = max(a, n0), min(b, n1)
                if i0 < i1:
                    shape = list(x.shape)
                    shape[dim] = i1 - i0
                    buf = x.new_empty(shape)
                    ops.append(dist.P2POp(dist.irecv, buf, chain[q], group, tag))
                    pieces.append((i0, buf))
            wants = ((max(0, a - before), a), (b, min(L, b + after)))
            for tag, (n0, n1) in enumerate(wants):
                i0, i1 = max(s0, n0), min(s1, n1)
                if i0 < i1:
                    ops.append(dist.P2POp(dist.isend, x.narrow(dim, i0 - s0, i1 - i0).contiguous(), chain[q], group, tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.counts["send_recv"] += 1

        def zeros(k):
            shape = list(x.shape)
            shape[dim] = k
            return x.new_zeros(shape)

        lo = [zeros(before - (need[0][1] - need[0][0]))] + [t for _, t in sorted(got[0], key=lambda p: p[0])]
        hi = [t for _, t in sorted(got[1], key=lambda p: p[0])] + [zeros(after - (need[1][1] - need[1][0]))]
        return torch.cat(lo + [x] + hi, dim=dim)

    def halo(self, x: torch.Tensor, stage: str, axis: str, L: int, N: int, before: int, after: int) -> torch.Tensor:
        """A ``stage`` block extended by halos along ``axis`` ('time': the
        row axis, dim -2; 'space': dim -1), exchanged with the ranks that
        hold the neighbouring blocks; zeros past the global ends. The
        canonical stage takes either halo, ``mode_local`` the time halo."""
        nt, ns, P = self.n_time, self.n_space, self.size
        r = self.mesh.ranks
        if stage == "canonical" and axis == "time":
            chain, pos = [r[t * ns + self.si] for t in range(nt)], self.ti
            bounds, dim, group = blocks(L, nt), -2, self.mesh.time_groups[self.si]
        elif stage == "canonical" and axis == "space":
            chain, pos = [r[self.ti * ns + s] for s in range(ns)], self.si
            bounds, dim, group = blocks(N, ns), -1, self.mesh.space_groups[self.ti]
        elif stage == "mode_local" and axis == "time":
            chain, pos, bounds, dim, group = list(r), self.index, blocks(L, P), -2, self.mesh.group
        else:
            raise ValueError(f"no {axis} halo in the {stage} stage: that axis is local there")
        return self._chain_halo(x, dim, bounds, chain, pos, before, after, group)

    def apply_stencil(
        self,
        x: torch.Tensor,
        fn: Callable[[torch.Tensor, int], torch.Tensor],
        L: int,
        space,
        t_halo: int,
    ) -> torch.Tensor:
        """A time-stencil operator on a canonical block ``(..., l, n)``.
        ``fn(ext, g0)`` applies the operator to a block extended by
        ``t_halo`` rows on either side whose first row is global row ``g0``;
        it must treat rows past the extended block as zero, and the result's
        outer ``t_halo`` rows are dropped. The spatial part:

        - grid space axis 1: space is whole in canonical; one time halo
          exchange (``batch_isend_irecv``);
        - 1D structured spaces (three-point stencils): a 1-column space halo,
          then the time halo of the space-extended block (its corners
          included); ``fn`` sees two extra columns, which are dropped;
        - other spaces (2D grids, meshes: the stencil reaches past the
          neighbouring space block): the block moves to ``mode_local`` (space
          whole), takes its time halo there and moves back: two
          ``all_to_all_single`` and one halo exchange."""
        N = space.n
        if self.n_space == 1:
            ext = self.halo(x, "canonical", "time", L, N, t_halo, t_halo)
            l0 = self.box("canonical", L, N)[0]
            return fn(ext, l0 - t_halo)[..., t_halo : ext.shape[-2] - t_halo, :]
        if getattr(space, "dim", None) == 1 and hasattr(space, "n1d"):
            ext = self.halo(x, "canonical", "space", L, N, 1, 1)
            ext = self.halo(ext, "canonical", "time", L, N, t_halo, t_halo)
            l0 = self.box("canonical", L, N)[0]
            return fn(ext, l0 - t_halo)[..., t_halo : ext.shape[-2] - t_halo, 1:-1]
        xm = self.move(x, "canonical", "mode_local", L, N)
        ext = self.halo(xm, "mode_local", "time", L, N, t_halo, t_halo)
        m0 = self.box("mode_local", L, N)[0]
        ym = fn(ext, m0 - t_halo)[..., t_halo : ext.shape[-2] - t_halo, :]
        return self.move(ym, "mode_local", "canonical", L, N)


def make_layout(n_time: int, n_space: int = 1, group=None) -> Optional[ParallelLayout]:
    """A :class:`ParallelLayout` on :func:`make_mesh` ``(n_time, n_space)``
    (collective over the default group, as :func:`make_mesh` is); None on a
    process outside the grid, which takes no part in its solves."""
    mesh = make_mesh(n_time, n_space, group)
    return None if mesh.index is None else ParallelLayout(mesh)


class IdentityLayout:
    """The stand-in for ``layout=None``: one process holds the whole state,
    every stage move and reduction is the identity, and nothing is
    communicated. The builders' pipelines read the same with and without
    sharding."""

    sharded = False

    @staticmethod
    def move(x, src, dst, L, N):
        return x

    @staticmethod
    def rows(stage, L):
        return slice(0, L)

    @staticmethod
    def all_reduce(t, op="sum"):
        return t


def resolve_layout(layout):
    """``layout`` itself, or an :class:`IdentityLayout` for None."""
    return IdentityLayout() if layout is None else layout
