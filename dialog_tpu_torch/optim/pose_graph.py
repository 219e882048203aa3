"""Sim3 essential-graph optimization, the loop-closure correction (port of
``dialog_tpu/optim/pose_graph.py``).

Nodes are per-keyframe Sim3 world->camera transforms; edges are the
spanning tree, the strong covisibility pairs and the loop edge, each with a
relative-Sim3 measurement. The solve is damped Gauss-Newton over one dense
[7K, 7K] system: the per-edge 7x7 Jacobian blocks are forward-mode
derivatives of the edge residual at zero perturbation, all edges
and all 14 directions in one evaluation (``optim.lm.jacobian_at_zero``), summed into the system's 7x7
blocks in a fixed order (``ops.segment_sum``, the order built once per solve: ``system_order``), so a
solve on the card repeats bit for bit. Decisions stay on the device: a fixed number of
iterations, each step kept or dropped with ``torch.where``, no host read
after the summation order's build (four).

Landmarks then move with their reference keyframe's correction
S_new^-1 o S_old, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import geometry as geo
from .. import ops
from ..config import EngineConfig
from ..containers import MapState
from .lm import jacobian_at_zero


class PoseGraphProblem(NamedTuple):
    # nodes (all keyframe slots; invalid ones frozen)
    s: torch.Tensor        # f32[K]
    R: torch.Tensor        # f32[K, 3, 3]
    t: torch.Tensor        # f32[K, 3]
    opt: torch.Tensor      # bool[K] optimize this node
    # edges with relative measurements S_ij = S_i o S_j^-1
    e_i: torch.Tensor      # i32[E]
    e_j: torch.Tensor      # i32[E]
    m_s: torch.Tensor      # f32[E]
    m_R: torch.Tensor      # f32[E, 3, 3]
    m_t: torch.Tensor      # f32[E, 3]
    e_ok: torch.Tensor     # bool[E]
    e_w: torch.Tensor      # f32[E] edge weight


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor, a Python number or a numpy array) in ``like``'s type, on its device; a
    number by a fill kernel (``ops.scalar``), not a host copy."""
    if isinstance(x, (int, float)):
        return ops.scalar(x, like.dtype, like.device)
    return torch.as_tensor(x).to(device=like.device, dtype=like.dtype)


def build_pose_graph(m: MapState, cfg: EngineConfig, loop_i, loop_j, loop_s, loop_R, loop_t,
                     fixed_kf) -> PoseGraphProblem:
    """Essential graph: spanning tree + covisibility (weight >= the
    configuration's ``essential_covis_th``, upper triangle, at most 4K
    edges in row-major order) + the loop edge (weight 5). Tree and
    covisibility edges measure the current relative poses at scale 1, the
    odometry to preserve; the loop edge measures the computed Sim3. Every
    valid node but ``fixed_kf`` is optimized, from scale 1."""
    kfs = m.kfs
    K = kfs.valid.shape[0]
    dev = kfs.R.device
    s0 = torch.ones(K, dtype=torch.float32, device=dev)
    R0, t0 = kfs.R, kfs.t

    ar = torch.arange(K, dtype=torch.int32, device=dev)
    tree_ok = kfs.valid & (kfs.parent >= 0)
    tree_j = torch.clamp(kfs.parent, 0, K - 1)

    covis = torch.where(kfs.valid[:, None] & kfs.valid[None, :], m.covis, 0)
    flat = (torch.triu(covis, 1) >= cfg.essential_covis_th).reshape(-1)
    E_cov = 4 * K
    cov_idx = ops.nonzero_fixed(flat, E_cov, 0)
    cov_ok = torch.arange(E_cov, device=dev) < flat.sum()

    e_i = torch.cat([ar, (cov_idx // K).to(torch.int32), _as(loop_i, ar).reshape(1)])
    e_j = torch.cat([tree_j, (cov_idx % K).to(torch.int32), _as(loop_j, ar).reshape(1)])
    e_ok = torch.cat([tree_ok, cov_ok, torch.ones(1, dtype=torch.bool, device=dev)])
    e_w = torch.cat([torch.ones(K + E_cov, dtype=torch.float32, device=dev),
                     torch.full((1,), 5.0, dtype=torch.float32, device=dev)])

    # measurements from the current poses: S_ij = S_i o S_j^-1 (scale 1); the loop edge's is the computed Sim3
    E = e_i.shape[0]
    ones = torch.ones(E, dtype=torch.float32, device=dev)
    ei, ej = e_i.long(), e_j.long()
    sj_inv, Rj_inv, tj_inv = geo.sim3_inv(ones, R0[ej], t0[ej])
    m_s, m_R, m_t = geo.sim3_compose(ones, R0[ei], t0[ei], sj_inv, Rj_inv, tj_inv)
    m_s = torch.cat([m_s[:-1], _as(loop_s, m_s).reshape(1)])
    m_R = torch.cat([m_R[:-1], _as(loop_R, m_R).reshape(1, 3, 3)])
    m_t = torch.cat([m_t[:-1], _as(loop_t, m_t).reshape(1, 3)])

    opt = kfs.valid & (ar != _as(fixed_kf, ar))
    return PoseGraphProblem(s=s0, R=R0, t=t0, opt=opt, e_i=e_i, e_j=e_j, m_s=m_s, m_R=m_R, m_t=m_t,
                            e_ok=e_ok, e_w=e_w)


def _edge_residual(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """r = log( S_ij_meas^-1 o (exp(xi_i) S_i) o (exp(xi_j) S_j)^-1 ) (7,)."""
    si2, Ri2, ti2 = geo.sim3_retract(si, Ri, ti, xi_i)
    sj2, Rj2, tj2 = geo.sim3_retract(sj, Rj, tj, xi_j)
    sji, Rji, tji = geo.sim3_inv(sj2, Rj2, tj2)
    s_ij, R_ij, t_ij = geo.sim3_compose(si2, Ri2, ti2, sji, Rji, tji)
    msi, mRi, mti = geo.sim3_inv(ms, mR, mt)
    s_e, R_e, t_e = geo.sim3_compose(msi, mRi, mti, s_ij, R_ij, t_ij)
    return geo.sim3_log(s_e, R_e, t_e)


def _edges(si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """Every edge's residual [E, 7] and its Jacobian [E, 7, 14] in (xi_i, xi_j) at zero."""
    f = lambda x: (_edge_residual(x[..., :7], x[..., 7:], si, Ri, ti, sj, Rj, tj, ms, mR, mt),)  # noqa: E731
    return jacobian_at_zero(f, 14, (si.shape[0],), Ri)[0]


def system_order(prob: PoseGraphProblem):
    """The fixed orders of ``_system``'s sums (``ops.segment_order``): the
    four 7x7 blocks of each edge into the K x K block grid of H, its two
    gradient blocks into the K node rows; an edge that is not ``e_ok``
    drops out. Depends on the edge list alone: one build per solve."""
    K = prob.s.shape[0]
    ei, ej = prob.e_i.long(), prob.e_j.long()
    i_ = torch.where(prob.e_ok, ei, -1)
    j_ = torch.where(prob.e_ok, ej, -1)
    rows, cols = torch.stack([i_, j_, i_, j_]), torch.stack([i_, j_, j_, i_])          # [4, E]
    blk = torch.where((rows >= 0) & (cols >= 0), rows * K + cols, -1)
    return ops.segment_order(blk, K * K), ops.segment_order(rows[:2], K)


def _system(prob: PoseGraphProblem, s, R, t, order=None):
    """(cost, H f32[7K, 7K], g f32[7K]) of the graph at the nodes (s, R, t);
    ``order``: ``system_order(prob)``, built here when absent."""
    K = s.shape[0]
    H_order, g_order = system_order(prob) if order is None else order
    ei, ej = prob.e_i.long(), prob.e_j.long()
    r, J = _edges(s[ei], R[ei], t[ei], s[ej], R[ej], t[ej], prob.m_s, prob.m_R, prob.m_t)
    w = torch.where(prob.e_ok, prob.e_w, 0.0)
    cost = torch.sum(w * torch.sum(r * r, -1))
    Ji, Jj = J[..., :7], J[..., 7:]
    blocks = torch.stack([torch.einsum("eai,e,eaj->eij", A, w, B) for A, B in ((Ji, Ji), (Jj, Jj), (Ji, Jj), (Jj, Ji))])
    g_blocks = torch.stack([torch.einsum("eai,e,ea->ei", A, w, r) for A in (Ji, Jj)])
    H = ops.segment_sum(blocks.reshape(-1, 7, 7), H_order).reshape(K, K, 7, 7)
    g = ops.segment_sum(g_blocks.reshape(-1, 7), g_order)
    return cost, H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K), g.reshape(7 * K)


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 20, lam0: float = 1e-4):
    """Damped GN over the Sim3 graph; returns (s, R, t, cost). Each
    iteration solves (H + diag(lam max(diag H, 1e-9) + 1e-9)) dx = -g with
    the frozen nodes' rows and columns replaced by the identity, retracts
    every node, and keeps the step where the weighted squared residual
    falls (lam halves) or drops it (lam quadruples)."""
    K = prob.s.shape[0]
    opt7 = prob.opt.repeat_interleave(7)
    keep = opt7[:, None] & opt7[None, :]
    frozen = torch.diag(torch.where(opt7, 0.0, 1.0))
    s, R, t = prob.s, prob.R, prob.t
    order = system_order(prob)
    cost, H, g = _system(prob, s, R, t, order)
    lam = ops.scalar(lam0, torch.float32, s.device)
    for _ in range(iters):
        Hd = H + torch.diag(lam * torch.clamp(torch.diagonal(H), min=1e-9) + 1e-9)
        Hd = torch.where(keep, Hd, 0.0) + frozen
        rhs = torch.where(opt7, -g, 0.0)
        dx = torch.linalg.solve_ex(Hd, rhs[:, None], check_errors=False)[0].reshape(K, 7)
        s2, R2, t2 = geo.sim3_retract(s, R, t, dx)
        R2 = geo.orthogonalize(R2)
        new_cost, H2, g2 = _system(prob, s2, R2, t2, order)
        accept = new_cost < cost
        s, R, t = torch.where(accept, s2, s), torch.where(accept, R2, R), torch.where(accept, t2, t)
        H, g = torch.where(accept, H2, H), torch.where(accept, g2, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return s, R, t, cost


def apply_pose_graph_correction(m: MapState, s_new, R_new, t_new, cfg: EngineConfig) -> MapState:
    """Write the corrected poses and move the landmarks with their reference
    keyframe: keyframe SE3 = [R | t/s] (reference: OptimizeEssentialGraph
    recovering Tiw from the optimized Siw); landmark X' = S_new^-1(S_old(X))
    with its reference keyframe's old and new transforms."""
    kfs, lms = m.kfs, m.lms
    K = kfs.valid.shape[0]
    R_old, t_old = kfs.R, kfs.t
    kfs = kfs._replace(
        R=torch.where(kfs.valid[:, None, None], R_new, R_old),
        t=torch.where(kfs.valid[:, None], t_new / s_new[:, None], t_old),
    )
    ref = torch.clamp(lms.ref_kf, 0, K - 1).long()
    ok = lms.valid & (lms.ref_kf >= 0)
    Xc = geo.se3_apply(R_old[ref], t_old[ref], lms.xyz)
    si, Ri, ti = geo.sim3_inv(s_new[ref], R_new[ref], t_new[ref])
    Xw = geo.sim3_apply(si, Ri, ti, Xc)
    return m._replace(kfs=kfs, lms=lms._replace(xyz=torch.where(ok[:, None], Xw, lms.xyz)))
