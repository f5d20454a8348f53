"""Symmetric eigendecomposition for the WCT's matrix powers: the CUDA
kernel and its plain twin.

``eigh_cn(cov [..., C, C]) → (s [..., C], u [..., C, C])`` returns what
``torch.linalg.eigh`` returns: eigenvalues in ascending order, signed
(an f32 rounding below zero stays below zero, so the hard 1e-5 mask
drops it), and orthonormal ``u`` with column i the eigenvector of
``s[..., i]``; like it, it reads the lower triangle.

- A float32 CUDA tensor with 1 ≤ C ≤ 512 launches ``eigh_cuda``, the
  hand-written kernel ``csrc/eigh_jacobi.cu`` (design and bound in the
  source): one launch for the whole batch, sweeps looped and convergence
  decided on the card, no copy to the host and no check of an ``info``
  there, so the host runs on while it computes. A float32 CUDA tensor
  with C > 512 raises; there is no fallback.
- float64 (the oracle's type) and CPU tensors take ``torch.linalg.eigh``.

The algorithm, the same in the kernel and in the plain twin
``_eigh_plain`` (the kernel's oracle on the card):

- Two-sided block Jacobi. C is padded to ``padded_edge(C)``, a multiple
  of 32, with zero rows and columns; the padded indices never couple to
  the rest (a rotation needs a nonzero off-diagonal entry) and are
  dropped from the output. The padded matrix is cut into blocks of
  ``BLOCK`` = 16 indices, paired by a round-robin tournament: a sweep is
  ``blocks − 1`` rounds, and in each round every block meets one other.
- A round. Each pair's 32 × 32 diagonal sub-matrix S gets one Jacobi
  sweep in steps of 16 disjoint rotations, each taken only where
  ``|s_pq| > tol·√|s_pp|·√|s_qq|`` (threshold Jacobi, which keeps the
  small eigenvalues' relative accuracy on a positive definite matrix).
  In a sweep's first round the steps are a round-robin over all 32
  indices (31 steps, which also meet each index with the rest of its own
  block); in the other rounds the 16 steps that meet each index of one
  block with each of the other's. So every pair of indices turns once a
  sweep, and the chain of dependent steps is 31 + 16·(blocks − 2) long,
  not 31·(blocks − 1); on the trained covariances it took as many
  sweeps. The kernel forms a rotation with the card's approximate square
  root and reciprocal, the twin with IEEE ones.
- The product Q of the sweep's rotations is re-orthogonalised once,
  ``Q ← Q − ½·Q(QᵀQ − I)`` (without it the rounding of some 300 rounds
  left ``u`` 30× less orthogonal than LAPACK's). Then every tile moves,
  ``A[P_l, P_k] ← Q_lᵀ A[P_l, P_k] Q_k``: for l < k mirrored below the
  diagonal, on the diagonal averaged with its transpose, so that A stays
  exactly symmetric (the rotated S itself there, inconsistent with the
  corrected Q, left the relu1_1 covariances' A^{−1/2} 3× farther from
  float64); and the eigenvectors ``V[:, P_k] ← V[:, P_k] Q_k``.
- Stopping. After each sweep a matrix stops once no off-diagonal entry
  exceeds ``tol·√|d_i|·√|d_j|``, ``tol = √padded_edge · 2⁻²³``, d the
  diagonals of the last round's rotated S's. ``MAX_SWEEPS`` caps the
  sweeps; the kernel counts the matrices that reach the cap in a counter
  on the card (``capped_sweeps``), read only when asked.
- Eigenvalues are the final diagonal, sorted ascending (stable: ties keep
  their index order), and the columns of V with them, after one more
  ``V ← V − ½·(VVᵀ − I)V`` (then 4× more orthogonal than LAPACK's).

Every product is f32 on the FFMA units: the tiles and V on the tensor
cores in 3×TF32 made a C = 512 call 6 % faster on the card and left an
ill-conditioned matrix's A^{−1/2} 35× farther from float64 than the
twin's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from wct_tpu_torch.utils.profiling import span

# Indices per block; a pair of blocks (32) is one inner problem.
BLOCK = 16
# The largest C the kernel takes: a matrix is a cluster of padded_edge / 32
# blocks of threads, and a cluster has at most 16.
MAX_C = 512
MAX_SWEEPS = 30
_EPS32 = 2.0 ** -23


def padded_edge(c: int) -> int:
    """The edge the decomposition works on: C rounded up to 32."""
    return 32 * -(-c // 32)


@functools.lru_cache(maxsize=None)
def tolerance(c: int) -> float:
    """The rotation threshold for a C × C matrix, as an f32 value."""
    return float(torch.tensor(math.sqrt(padded_edge(c)) * _EPS32, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def round_robin(players: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """The circle method's tournament on ``players`` (even) indices:
    ``players − 1`` rounds of ``players / 2`` disjoint pairs. Player 0
    stays; in round r the others sit at ``(i − 1 + r) mod (players − 1) + 1``
    and seat k meets seat ``players − 1 − k``."""
    m = players - 1
    rounds = []
    for r in range(m):
        seat = [0] + [(i - 1 + r) % m + 1 for i in range(1, players)]
        rounds.append(tuple((seat[k], seat[players - 1 - k]) for k in range(players // 2)))
    return tuple(rounds)


def _cross_steps() -> tuple[tuple[tuple[int, int], ...], ...]:
    """The 16 steps that meet each index of a pair's first block with each of
    its second: step e pairs a with ``16 + (a + e) mod 16``."""
    return tuple(tuple((a, BLOCK + (a + e) % BLOCK) for a in range(BLOCK)) for e in range(BLOCK))


@functools.lru_cache(maxsize=None)
def _inner_indices(cross: bool, device: torch.device) -> tuple[torch.Tensor, ...]:
    """Per step of an inner sweep (the round-robin over all 32 indices, or
    with ``cross`` the 16 steps between the two blocks), flat indices into
    S [32·32]: the 120 off-diagonal 2 × 2 blocks (pair m's rows p_m, q_m
    against pair m' > m's columns), the same blocks mirrored, the 16
    diagonal blocks, each block's m and m', and the pairs' p and q. Stacked
    over the steps."""
    up, mirror, diag, mi, mj, pp, qq = [], [], [], [], [], [], []
    for pairs in _cross_steps() if cross else round_robin(2 * BLOCK):
        rows = [(p, q) for p, q in pairs]
        u, w, i0, j0 = [], [], [], []
        for m in range(len(rows)):
            for m2 in range(m + 1, len(rows)):
                u.append([[32 * rows[m][a] + rows[m2][b] for b in range(2)] for a in range(2)])
                w.append([[32 * rows[m2][b] + rows[m][a] for b in range(2)] for a in range(2)])
                i0.append(m)
                j0.append(m2)
        up.append(u)
        mirror.append(w)
        diag.append([[[32 * r[a] + r[b] for b in range(2)] for a in range(2)] for r in rows])
        mi.append(i0)
        mj.append(j0)
        pp.append([p for p, _ in rows])
        qq.append([q for _, q in rows])
    return tuple(torch.tensor(x, device=device) for x in (up, mirror, diag, mi, mj, pp, qq))


def _rotations(app, aqq, apq, tol: float):
    """Jacobi rotations annihilating ``apq`` (Rutishauser's form), where
    ``|apq| > tol·√|app|·√|aqq|``; identity elsewhere. Returns (c, s, the
    rotated diagonal entries, which pairs rotate)."""
    rot = apq.abs() > tol * app.abs().sqrt() * aqq.abs().sqrt()
    safe = torch.where(rot, apq, torch.ones_like(apq))
    theta = (aqq - app) / (2.0 * safe)
    t = torch.where(theta.abs() > 1e15, 0.5 / theta,
                    torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0)))
    t = torch.where(theta == 0, torch.ones_like(t), t)
    t = torch.where(rot, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    return c, s, app - t * apq, aqq + t * apq, rot


def _inner_sweep(s_blk: torch.Tensor, tol: float, cross: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi sweep of ``s_blk [N, 32, 32]``, steps of 16 disjoint
    rotations (``_inner_indices``): ``(S', Q)`` with ``S' ≈ QᵀSQ``, Q
    re-orthogonalised."""
    up, mirror, diag, mi, mj, pp, qq = _inner_indices(cross, s_blk.device)
    n = s_blk.shape[0]
    s_flat = s_blk.reshape(n, 1024).clone()
    q = torch.eye(32, dtype=s_blk.dtype, device=s_blk.device).repeat(n, 1, 1)
    for e in range(up.shape[0]):
        d = s_flat[:, diag[e]]  # [N, 16, 2, 2]
        c, s, npp, nqq, rot = _rotations(d[..., 0, 0], d[..., 1, 1], d[..., 0, 1], tol)
        x = s_flat[:, up[e]]  # [N, 120, 2, 2]
        cr, sr = c[:, mi[e], None], s[:, mi[e], None]
        y0 = cr * x[..., 0, :] - sr * x[..., 1, :]
        y1 = sr * x[..., 0, :] + cr * x[..., 1, :]
        cc, sc = c[:, mj[e]], s[:, mj[e]]
        y = torch.stack([
            torch.stack([cc * y0[..., 0] - sc * y0[..., 1], sc * y0[..., 0] + cc * y0[..., 1]], -1),
            torch.stack([cc * y1[..., 0] - sc * y1[..., 1], sc * y1[..., 0] + cc * y1[..., 1]], -1),
        ], -2)
        s_flat[:, up[e]] = y
        s_flat[:, mirror[e]] = y
        zero = torch.zeros_like(npp)
        rotated = torch.stack([torch.stack([npp, zero], -1), torch.stack([zero, nqq], -1)], -2)
        s_flat[:, diag[e]] = torch.where(rot[..., None, None], rotated, d)
        qp, qqc = q[:, :, pp[e]], q[:, :, qq[e]]
        cq, sq = c[:, None, :], s[:, None, :]
        q[:, :, pp[e]] = cq * qp - sq * qqc
        q[:, :, qq[e]] = sq * qp + cq * qqc
    err = q.mT @ q - torch.eye(32, dtype=q.dtype, device=q.device)
    q = q - 0.5 * (q @ err)
    return s_flat.reshape(n, 32, 32), q


def _off_converged(a: torch.Tensor, root: torch.Tensor, tol: float) -> torch.Tensor:
    """Per matrix of ``a [N, n, n]``: no off-diagonal entry above
    ``tol·root_i·root_j`` (``root [N, n]``, √|d| of the rotated S's)."""
    over = a.abs() > tol * root[:, :, None] * root[:, None, :]
    over.diagonal(dim1=-2, dim2=-1).fill_(False)
    return ~over.flatten(1).any(-1)


def _eigh_plain(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch on ``a [B, C, C]`` f32, on
    ``a``'s device: ``(s [B, C] ascending, u [B, C, C], sweeps [B])``."""
    b, c, _ = a.shape
    n_p = padded_edge(c)
    nb, k = n_p // BLOCK, n_p // (2 * BLOCK)
    tol = tolerance(c)
    dev = a.device
    work = torch.zeros((b, n_p, n_p), dtype=torch.float32, device=dev)
    work[:, :c, :c] = a.tril() + a.tril(-1).mT  # the lower triangle, as eigh reads it
    vt = torch.eye(n_p, dtype=torch.float32, device=dev).repeat(b, 1, 1)  # rows: eigenvectors
    sweeps = torch.zeros(b, dtype=torch.int64, device=dev)
    active = torch.arange(b, device=dev)
    ar = torch.arange(BLOCK, device=dev)
    iu = torch.triu_indices(k, k, 1, device=dev)
    kk = torch.arange(k, device=dev)
    for _ in range(MAX_SWEEPS):
        if active.numel() == 0:
            break
        x, v = work[active], vt[active]
        m = x.shape[0]
        for r, pairs in enumerate(round_robin(nb)):
            idx = (torch.tensor(pairs, device=dev)[:, :, None] * BLOCK + ar).reshape(-1)  # P_0 .. P_{k-1}
            tiles = x[:, idx][:, :, idx].reshape(m, k, 32, k, 32).transpose(2, 3)
            s_new, q = _inner_sweep(tiles[:, kk, kk].reshape(m * k, 32, 32), tol, cross=r > 0)
            s_new, q = s_new.reshape(m, k, 32, 32), q.reshape(m, k, 32, 32)
            y = (q.mT[:, :, None] @ tiles) @ q[:, None]
            y[:, iu[1], iu[0]] = y[:, iu[0], iu[1]].mT
            d = y[:, kk, kk]
            y[:, kk, kk] = 0.5 * (d + d.mT)
            x[:, idx[:, None], idx[None, :]] = y.transpose(2, 3).reshape(m, n_p, n_p)
            rows = v[:, idx].reshape(m, k, 32, n_p)
            v[:, idx] = (q.mT @ rows).reshape(m, n_p, n_p)
            root = torch.empty((m, n_p), device=dev)
            root[:, idx] = s_new.diagonal(dim1=-2, dim2=-1).reshape(m, n_p).abs().sqrt()
        work[active], vt[active] = x, v
        sweeps[active] += 1
        active = active[~_off_converged(x, root, tol)]
    vt = vt - 0.5 * ((vt @ vt.mT - torch.eye(n_p, device=dev)) @ vt)
    d = work.diagonal(dim1=-2, dim2=-1)[:, :c]
    s, order = torch.sort(d, dim=-1, stable=True)
    u = torch.gather(vt[:, :c, :c], 1, order[:, :, None].expand(b, c, c)).mT
    return s, u.contiguous(), sweeps


def eigh_cuda(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on ``a [B, C, C]`` (f32, contiguous, on the card,
    1 ≤ C ≤ 512): ``(s [B, C], u [B, C, C])`` as ``torch.linalg.eigh``.
    Launches once on the current stream and does not synchronise; raises
    on any input the kernel does not take, and if the launch fails.
    ``eigh_cuda.launches`` counts the launches."""
    name = "eigh_cuda"
    if a.dim() != 3 or a.shape[1] != a.shape[2] or 0 in a.shape:
        raise ValueError(f"{name} needs a non-empty a [B, C, C], got {tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name} needs float32, got {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {a.device}")
    if not a.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    b, c, _ = a.shape
    if c > MAX_C:
        raise ValueError(f"{name} takes C ≤ {MAX_C}, got {c}")
    if b > 65535:
        raise ValueError(f"{name} takes at most 65535 matrices, got {b}")
    from wct_tpu_torch.ops import _build

    ptr, integer = ctypes.c_void_p, ctypes.c_int
    workspace_floats = _build.load("eigh_jacobi").eigh_jacobi_workspace_floats
    workspace_floats.argtypes, workspace_floats.restype = [integer, integer], ctypes.c_longlong
    s = torch.empty((b, c), dtype=torch.float32, device=a.device)
    u = torch.empty((b, c, c), dtype=torch.float32, device=a.device)
    work = torch.empty(workspace_floats(b, c), dtype=torch.float32, device=a.device)
    capped = _capped_counter(a.device)
    _build.launch(name, "eigh_jacobi", "eigh_jacobi_f32",
                  [ptr] * 5 + [integer] * 3 + [ctypes.c_float],
                  (a.data_ptr(), s.data_ptr(), u.data_ptr(), work.data_ptr(),
                   capped.data_ptr(), b, c, MAX_SWEEPS, tolerance(c)), a.device)
    eigh_cuda.launches += 1
    return s, u


eigh_cuda.launches = 0
# Per card: a one-element int32 tensor the kernel adds to for every matrix
# that reaches MAX_SWEEPS unconverged.
eigh_cuda.capped = {}


def _capped_counter(device: torch.device) -> torch.Tensor:
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in eigh_cuda.capped:
        eigh_cuda.capped[index] = torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}")
    return eigh_cuda.capped[index]


def capped_sweeps(device="cuda") -> int:
    """How many matrices reached ``MAX_SWEEPS`` unconverged in the kernel on
    ``device`` so far. Copies one integer to the host, so it waits for the
    card: read it outside the hot path."""
    return int(_capped_counter(torch.device(device)).item())


def eigh_cn(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of ``cov [..., C, C]`` in the span ``wct.op.eigh``:
    the kernel for a float32 CUDA tensor (C ≤ 512, else it raises),
    ``torch.linalg.eigh`` for any other."""
    with span("wct.op.eigh"):
        if cov.device.type != "cuda" or cov.dtype != torch.float32:
            return torch.linalg.eigh(cov)
        lead, c = cov.shape[:-2], cov.shape[-1]
        flat = cov.reshape(-1, c, c).contiguous()
        if flat.shape[0] == 0:
            return (cov.new_empty((*lead, c)), cov.new_empty((*lead, c, c)))
        s, u = eigh_cuda(flat)
        return s.reshape(*lead, c), u.reshape(*lead, c, c)
