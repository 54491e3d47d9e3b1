"""Hand-written collective implementations of the hot path (1D).

The counterpart of ``optimal_control_paradiag_tpu/parallel/shardmap_ops.py``,
the explicit-control twin of the layout pipeline (``parallel/solve.py``):
every communication step is a named collective on the ('time', 'space')
grid's axis groups, the equivalent of the reference's MPI layer (halo
exchange inside PETSc SpMV):

- **matvec**: the layout path itself. In torch the layout already issues its
  halos explicitly (``ParallelLayout.apply_stencil``: one 1-column space
  halo and one 2-row time halo by ``batch_isend_irecv``, zeros at the global
  ends), so there is no compiler-placed path for a twin to differ from; the
  builder keeps the JAX twin's 1D and even-shape contract;
- **fulldiag PC apply**: each transform (time DFT, space DST) is one local
  matmul of the block against the full transform matrix followed by a
  ``reduce_scatter_tensor`` over the contracted grid axis (the JAX
  package's ``psum_scatter``), so data lands directly in the next stage's
  layout. Modes stay split over the 'time' axis, wavenumbers over 'space';
  the per-(mode, wavenumber) 2x2 Cramer constants are sliced per rank. All
  arithmetic is split-real, as in the JAX package.

The returned functions map this rank's canonical block ``(2, N_t/nt,
n/ns)`` to its block of the result; the shapes must divide the grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from optimal_control_paradiag_torch.ops.allatonce import AllAtOnceOperator
from optimal_control_paradiag_torch.paradiag.eigs import circulant_eigs
from optimal_control_paradiag_torch.parallel.sharding import ParallelLayout
from optimal_control_paradiag_torch.utils.constants import to_device

# torch 2.13 renames reduce_scatter_tensor to reduce_scatter_single
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _psum_scatter(layout: ParallelLayout, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Sum ``x`` over the ranks of this rank's ``axis`` group and keep this
    rank's block along ``dim`` (the JAX ``psum_scatter(tiled=True)``): one
    ``reduce_scatter_tensor``."""
    mesh = layout.mesh
    group = mesh.time_groups[layout.si] if axis == "time" else mesh.space_groups[layout.ti]
    parts = mesh.n_time if axis == "time" else mesh.n_space
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // parts,) + tuple(src.shape[1:]))
    _reduce_scatter(out, src, group=group)
    layout.counts["reduce_scatter"] += 1
    return out.movedim(0, dim)


def _check_even(N_t: int, n: int, nt: int, ns: int) -> None:
    if N_t % nt or n % ns:
        raise ValueError(
            "the explicit-collective ops need evenly dividing shards (fixed per-rank "
            f"blocks): need nt | N_t and ns | n; got N_t={N_t}, nt={nt}, n={n}, ns={ns} -- "
            "the layout path (parallel.solve.make_sharded_solver) handles uneven shapes"
        )


def build_shardmap_matvec(op: AllAtOnceOperator, layout: ParallelLayout):
    """The all-at-once matvec on canonical blocks (1D): ``op.matvec`` under
    ``layout`` (module docstring), behind the JAX twin's refusals."""
    if op.space.dim != 1:
        raise NotImplementedError("the explicit-collective matvec is 1D; the layout path covers 2D")
    _check_even(op.N_t, op.space.n, layout.n_time, layout.n_space)
    return lambda x: op.matvec(x, layout=layout)


def build_shardmap_preconditioner(op: AllAtOnceOperator, layout: ParallelLayout):
    """Explicit-collective fulldiag ParaDiag apply (1D).

    Block invariant: global time / modes are split over the 'time' grid axis
    (block tb = N_t/nt), global space / wavenumbers over 'space' (block
    nb = n/ns). Per apply, in split-real arithmetic:

      1. time DFT:  partial (all modes, local cols) = C/S[:, t_blk] @ r,
                    reduce-scattered over 'time'   -> mode block ti
      2. space DST: partial (local modes, all j) = part @ V[x_blk, :],
                    reduce-scattered over 'space'  -> wavenumber block si
      3. the 2x2 Cramer solve with (a11, coup, det) sliced at (ti, si)
      4. inverse DST (contract local j, scatter over 'space')
      5. inverse real DFT (contract local modes, scatter over 'time')
    """
    sp = op.space
    if sp.dim != 1 or not sp.diagonalizable:
        raise NotImplementedError("explicit-collective PC: 1D fulldiag only (the layout path covers the rest)")
    if not op.scaled:
        raise ValueError("ParaDiag requires the scaled system")
    nt, ns = layout.n_time, layout.n_space
    N_t, n = op.N_t, sp.n
    _check_even(N_t, n, nt, ns)
    rdtype, dev = sp.dtype, sp.device
    tb, nb = N_t // nt, n // ns
    krow, jcol = layout.ti * tb, layout.si * nb  # this rank's mode and wavenumber blocks
    e = circulant_eigs(N_t, op.dt, op.gamma)
    c = 0.5 * op.dt * op.dt
    muM, muK = (np.asarray(a, np.float64) for a in sp.spectrum)
    L1 = np.asarray(e.Lambda1)[:, None]
    L2 = np.asarray(e.Lambda2)[:, None]
    a11_h = (L1 * muM[None, :] + c * L2 * muK[None, :])[krow : krow + tb, jcol : jcol + nb]
    coup_h = (op.dt * op.dt / math.sqrt(op.gamma)) * muM[None, jcol : jcol + nb] * np.ones((tb, 1))
    det_h = np.abs(a11_h) ** 2 + coup_h**2
    a11r, a11i = to_device(a11_h.real, rdtype, dev), to_device(a11_h.imag, rdtype, dev)
    coup, det = to_device(coup_h, rdtype, dev), to_device(det_h, rdtype, dev)

    ang = 2.0 * np.pi * np.outer(np.arange(N_t), np.arange(N_t)) / N_t
    Ct = to_device(np.cos(ang)[:, krow : krow + tb], rdtype, dev)  # (N_t, tb): time rows / modes of this rank
    St = to_device(np.sin(ang)[:, krow : krow + tb], rdtype, dev)
    i_ = np.arange(1, sp.N_x)
    Vb = to_device(np.sin(np.pi * np.outer(i_, i_) / sp.N_x)[jcol : jcol + nb], rdtype, dev)  # (nb, n)

    def apply(r: torch.Tensor) -> torch.Tensor:
        # 1. time DFT (ifft of real r): contract local time rows
        pre = torch.einsum("kt,ctn->ckn", Ct, r)
        pim = torch.einsum("kt,ctn->ckn", St, r)
        part = torch.stack([pre, pim]) * (1.0 / N_t)  # (ri, comp, N_t, nb)
        part = _psum_scatter(layout, part, 2, "time")  # (2, 2, tb, nb): modes block ti
        # 2. space DST: contract local space columns against V rows
        part = torch.einsum("xj,rcmx->rcmj", Vb, part)  # (2, 2, tb, n)
        part = _psum_scatter(layout, part, 3, "space")  # wavenumber block si
        # 3. Cramer 2x2 per (mode, wavenumber):
        #    yu = (conj(a11) ru + coup rp)/det ; yp = (a11 rp - coup ru)/det
        rur, rui, rpr, rpi = part[0, 0], part[1, 0], part[0, 1], part[1, 1]
        yur = (a11r * rur + a11i * rui + coup * rpr) / det
        yui = (a11r * rui - a11i * rur + coup * rpi) / det
        ypr = (a11r * rpr - a11i * rpi - coup * rur) / det
        ypi = (a11r * rpi + a11i * rpr - coup * rui) / det
        yt = torch.stack([torch.stack([yur, ypr]), torch.stack([yui, ypi])])
        # 4. inverse DST: contract local wavenumbers
        part = torch.einsum("jx,rcmj->rcmx", Vb, yt) * (2.0 / sp.N_x)
        part = _psum_scatter(layout, part, 3, "space")  # space block si
        # 5. inverse DFT, real part: contract local modes
        yre = torch.einsum("tk,ckn->ctn", Ct, part[0]) + torch.einsum("tk,ckn->ctn", St, part[1])
        return _psum_scatter(layout, yre, 1, "time").to(rdtype)  # (2, tb, nb) canonical

    return apply
