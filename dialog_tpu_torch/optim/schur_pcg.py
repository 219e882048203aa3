"""Matrix-free Schur-complement PCG for large bundle adjustment (port of
``dialog_tpu/optim/schur_pcg.py``).

The dense reduced camera system ``S = Hcc - Y Hll^-1 Y^T`` that
``local_ba.solve_ba`` forms is O((6C)^2) in memory and O((6C)^2 3P) in
operations: fine for covisibility windows and for global BA up to
``global_ba.DENSE_SCHUR_MAX_CAMS`` cameras, not at the KITTI00 preset's
C = 2048, P = 262,144. This solver never forms S: each CG iteration applies
it from the per-observation factors

    S x = Hcc_d x - sum_p Y_p (Hll_p^-1 (Y_p^T x_{cams(p)}))

at O(P O) cost, with a block-Jacobi preconditioner made of S's exact 6x6
diagonal blocks (a landmark is observed at most once per camera, so the
diagonal of the pair term is a plain segment sum of (Y L^-T)(Y L^-T)^T).

Plain PyTorch, as the reference is plain XLA: einsums, gathers, and segment
sums into the C camera rows in a fixed order (``ops.segment_sum``), so a
solve on the card repeats bit for bit. The order depends only on the
problem's ``obs_cam``: ``segment_orders`` builds it once per problem (one
for the whole problem, one per construction slab), and the engine's
asynchronous GBA builds it when it starts and hands it to every
``lm_steps_pcg``. (A float ``index_add_`` adds in whatever order its
atomics land on CUDA: ROADMAP D15.)

No host read per CG iteration: every iteration's update is masked by an
``active`` flag kept on the device, ``n_cg`` counts the active iterations
there (as the reference's while loop counts them), and a masked iteration
leaves the iterate as it is, so the solution is that of an exit at the
first converged iteration. The host reads the flag once every
``CG_CHECK_EVERY`` iterations and stops the loop when it is down: at most
``CG_CHECK_EVERY - 1`` iterations of work are spent after convergence.

With a process group each rank holds a slice of the landmarks and every
camera (``global_ba.shard_problem``), and one ``all_reduce`` per LM step
sums the camera-side terms (``g_c``, ``Hcc``, ``g_red``, ``Dsub``), one per
CG iteration the [C, 6] landmark part of the matvec, and one per LM step
the new cost with its count of non-finite landmarks. Every decision is then
taken from summed values, the same on every rank, so the ranks stay in step.
"""

from __future__ import annotations

import torch

from .. import geometry as geo
from .. import ops
from ..config import EngineConfig
from ..distributed import all_sum
from .lm import chol3x3, tri_inv3x3_lower
from .local_ba import BAProblem, _delta2_of, _residuals, _robust_weights, _use_stereo, global_cost

# landmarks per slab of the construction phase (problems above it are cut into slabs of at most this many):
# the slab's einsum temporaries ([P, O, 6, 6] Hcc and Dsub terms, the Jacobians) take some 10 KB a landmark
# at O = 12, so one slab of 131,072 stays near 1.3 GB on an 80 GB card; the back-substitution factors (Y, Hll^-1,
# g_l) stay whole (the reference cut at 65,536 into slabs of 16,384 for a 16 GB chip)
SLAB_LMS = 131072
CG_CHECK_EVERY = 8   # CG iterations between two host reads of the exit flag


def _slab_len(P: int, chunk: bool) -> int:
    return SLAB_LMS if chunk and P > SLAB_LMS else P


def segment_orders(prob: BAProblem, chunk: bool = True):
    """The fixed orders of the PCG's camera-side segment sums for ``prob``
    (``ops.segment_order`` of each slot's camera; slots without one drop
    out): ``(whole problem, [one per construction slab])``. Depends on
    ``obs_cam`` alone, so one build serves every LM iteration of a solve."""
    C = prob.cam_slots.shape[0]
    P = prob.obs_cam.shape[0]
    cam = torch.clamp(prob.obs_cam, 0, C)               # C: no camera
    whole = ops.segment_order(cam, C)
    Pc = _slab_len(P, chunk)
    slabs = [whole] if Pc == P else [ops.segment_order(cam[lo : min(lo + Pc, P)], C) for lo in range(0, P, Pc)]
    return whole, slabs


def _cost_fn(prob: BAProblem, cfg: EngineConfig, chi2_th, group=None):
    """The LM cost at (R, t, xyz) and whether R, t and every rank's
    landmarks are finite."""
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    bf = cfg.bf if _use_stereo(prob, cfg) else 0.0
    delta2 = _delta2_of(prob, cfg, chi2_th)

    def cost_of(R, t, xyz):
        r, _, _, ok = _residuals(prob, R, t, xyz, fx, fy, cx, cy, bf)
        _, cost, _ = _robust_weights(r, prob.obs_w, ok, delta2)
        # cheirality penalty, as in local_ba.solve_ba's cost_of
        n_behind = torch.sum((prob.obs_ok & ~ok).to(torch.float32))
        return global_cost(cost + 1e3 * n_behind, R, t, xyz, group)

    return cost_of


def _lm_machinery(prob: BAProblem, cfg: EngineConfig, chi2_th, cg_iters: int, cg_tol: float = 1e-6,
                  chunk: bool = True, group=None, seg=None):
    """The PCG LM iteration ``body``, shared by ``solve_ba_pcg`` and
    ``lm_steps_pcg``. The LM carry is ``(R, t, xyz, lam, cost, cg_total)``;
    ``cg_total`` counts the CG iterations that ran (one ``all_reduce`` each
    on a sharded problem). ``seg``: ``segment_orders(prob, chunk)``, built
    here when absent."""
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    C = prob.cam_slots.shape[0]
    P, O = prob.obs_cam.shape
    bf = cfg.bf if _use_stereo(prob, cfg) else 0.0
    delta2 = _delta2_of(prob, cfg, chi2_th)
    dev, dt = prob.xyz.device, prob.xyz.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    cam = torch.clamp(prob.obs_cam, 0, C).long()        # C = pad row (gathers a zero)
    whole, slab_orders = segment_orders(prob, chunk) if seg is None else seg
    opt6 = prob.cam_opt[:, None]                         # [C, 1]
    Pc = _slab_len(P, chunk)
    cost_of = _cost_fn(prob, cfg, chi2_th, group)

    def seg6(order, vals):
        """Segment-sum [p, O, ...] observation values into [C] camera rows."""
        return ops.segment_sum(vals.reshape((-1,) + vals.shape[2:]), order)

    def slab_terms(s, R, t, xyz, lam):
        """Landmark slab ``s``: its factors and its camera-side sums, packed."""
        sp = prob._replace(
            obs_cam=prob.obs_cam[s], obs_uv=prob.obs_uv[s], obs_w=prob.obs_w[s], obs_ok=prob.obs_ok[s],
            obs_ur=None if prob.obs_ur is None else prob.obs_ur[s],
            lm_opt=None if prob.lm_opt is None else prob.lm_opt[s],
        )
        d2 = delta2[s] if torch.is_tensor(delta2) else delta2
        r, J_c, J_l, ok = _residuals(sp, R, t, xyz[s], fx, fy, cx, cy, bf)
        w, _, _ = _robust_weights(r, sp.obs_w, ok, d2)
        opt_of_obs = prob.cam_opt[torch.clamp(sp.obs_cam, 0, C - 1).long()]
        J_c = torch.where(opt_of_obs[..., None, None], J_c, 0.0)
        if sp.lm_opt is not None:
            J_l = torch.where(sp.lm_opt[:, None, None, None], J_l, 0.0)
        rows_s = slab_orders[s.start // Pc]

        # landmark blocks (the same arithmetic as solve_ba's reduction)
        Hll = torch.einsum("poki,po,pokj->pij", J_l, w, J_l)
        g_l = torch.einsum("poki,po,pok->pi", J_l, w, r)
        dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        Hll_d = Hll + (lam * torch.clamp(dll, min=1e-9) + 1e-9)[..., None] * eye3
        Ld_inv = tri_inv3x3_lower(chol3x3(Hll_d))
        Hll_inv = torch.einsum("pki,pkj->pij", Ld_inv, Ld_inv)

        # per-observation camera factors
        Y = torch.einsum("poki,po,pokj->poij", J_c, w, J_l)          # [p, O, 6, 3]
        g_c = seg6(rows_s, torch.einsum("poki,po,pok->poi", J_c, w, r))
        Hcc = seg6(rows_s, torch.einsum("poki,po,pokj->poij", J_c, w, J_c))
        g_red = seg6(rows_s, torch.einsum("poij,pj->poi", Y, torch.einsum("pij,pj->pi", Hll_inv, g_l)))
        YL = torch.einsum("poij,pjk->poik", Y, Ld_inv.transpose(-1, -2))
        Dsub = seg6(rows_s, torch.einsum("poik,pojk->poij", YL, YL))
        return Hll_inv, g_l, Y, torch.cat([g_c.reshape(-1), Hcc.reshape(-1), g_red.reshape(-1), Dsub.reshape(-1)])

    def step(R, t, xyz, lam):
        slabs = [slab_terms(slice(lo, min(lo + Pc, P)), R, t, xyz, lam) for lo in range(0, P, Pc)]
        if len(slabs) == 1:
            Hll_inv, g_l, Y, cams = slabs[0]
        else:
            Hll_inv, g_l, Y = (torch.cat([s[i] for s in slabs]) for i in range(3))
            cams = torch.stack([s[3] for s in slabs]).sum(0)
        cams = all_sum(cams, group)   # once per LM step on a sharded problem
        g_c, Hcc, g_red, Dsub = torch.split(cams, [6 * C, 36 * C, 6 * C, 36 * C])
        g_c, g_red = g_c.reshape(C, 6), g_red.reshape(C, 6)
        Hcc, Dsub = Hcc.reshape(C, 6, 6), Dsub.reshape(C, 6, 6)

        dcc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_d = Hcc + (lam * torch.clamp(dcc, min=1e-9) + 1e-9)[..., None] * eye6
        # frozen cameras: identity rows keep the system nonsingular while the
        # zero right-hand side pins their update to zero
        Hcc_d = torch.where(prob.cam_opt[:, None, None], Hcc_d, eye6)

        # block-Jacobi preconditioner: the exact 6x6 diagonal of S. inv_ex
        # leaves out inv's check of the factorization, a host read
        D = torch.where(prob.cam_opt[:, None, None], Hcc_d - Dsub, eye6)
        D_inv = torch.linalg.inv_ex(D + 1e-8 * eye6, check_errors=False)[0]
        pad = torch.zeros((1, 6), dtype=dt, device=dev)

        def matvec(x):                                                # x [C, 6]
            x = torch.where(opt6, x, 0.0)
            y = torch.einsum("cij,cj->ci", Hcc_d, x)
            xg = torch.cat([x, pad])[cam]                             # [P, O, 6]
            u = torch.einsum("poij,poi->pj", Y, xg)                   # [P, 3]
            wv = torch.einsum("pij,pj->pi", Hll_inv, u)
            y = y - all_sum(seg6(whole, torch.einsum("poij,pj->poi", Y, wv)), group)
            return torch.where(opt6, y, 0.0)

        def precond(x):
            return torch.where(opt6, torch.einsum("cij,cj->ci", D_inv, x), 0.0)

        def safe_div(a, b):
            big = torch.abs(b) > 1e-20
            return torch.where(big, a / torch.where(big, b, 1.0), 0.0)

        # PCG with an exit on the M-norm relative residual, decided on the device
        b = torch.where(opt6, -(g_c - g_red), 0.0)
        x = torch.zeros((C, 6), dtype=dt, device=dev)
        res, z = b, precond(b)
        p, rz = z, torch.sum(b * z)
        stop_at = cg_tol * rz
        active = rz > stop_at
        n_cg = ops.scalar(0, torch.int32, dev)
        for i in range(cg_iters):
            if i and i % CG_CHECK_EVERY == 0 and not bool(active):   # the one host read of k iterations
                break
            Ap = matvec(p)
            alpha = safe_div(rz, torch.sum(p * Ap))
            x_n = x + alpha * p
            res_n = res - alpha * Ap
            z_n = precond(res_n)
            rz_n = torch.sum(res_n * z_n)
            p_n = z_n + safe_div(rz_n, rz) * p
            x, res, z, p = (torch.where(active, a, o) for a, o in ((x_n, x), (res_n, res), (z_n, z), (p_n, p)))
            rz = torch.where(active, rz_n, rz)
            n_cg = n_cg + active.to(torch.int32)
            active = active & (rz > stop_at)
        dc = x

        # landmark back-substitution
        cross = torch.einsum("poij,poi->pj", Y, torch.cat([dc, pad])[cam])
        dl = torch.einsum("pij,pj->pi", Hll_inv, -g_l - cross)
        R_new, t_new = geo.se3_retract(R, t, dc)
        return R_new, t_new, xyz + dl, n_cg

    def body(carry):
        R, t, xyz, lam, cost, cg_total = carry
        R_new, t_new, xyz_new, n_cg = step(R, t, xyz, lam)
        new_cost, finite = cost_of(R_new, t_new, xyz_new)
        accept = (new_cost < cost) & finite
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        xyz = torch.where(accept, xyz_new, xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
        return R, t, xyz, lam, cost, cg_total + n_cg

    return body


def solve_ba_pcg(prob: BAProblem, cfg: EngineConfig, iters: int = 10, chi2_th: float = 5.991, lam0: float = 1e-4,
                 cg_iters: int = 48, cg_tol: float = 1e-6, return_cg_iters: bool = False, chunk: bool = True,
                 group=None):
    """Damped LM with a matrix-free Schur PCG camera solve: the same damping,
    robust weights and accept rule as ``local_ba.solve_ba``, for problems
    whose reduced camera system is too large to form. Returns (R [C,3,3],
    t [C,3], xyz [P,3], final robust cost), and the CG iterations run in all
    (a 0-d int32 tensor) with ``return_cg_iters``. ``chunk`` cuts the
    construction into slabs of ``SLAB_LMS`` landmarks; ``group``: the
    problem is this rank's landmark slice (``global_ba.shard_problem``)."""
    carry = lm_init_pcg(prob, cfg, chi2_th, lam0, cg_iters, group=group)
    body = _lm_machinery(prob, cfg, chi2_th, cg_iters, cg_tol, chunk, group)
    for _ in range(iters):
        carry = body(carry)
    R, t, xyz, _, cost, cg_total = carry
    if return_cg_iters:
        return geo.orthogonalize(R), t, xyz, cost, cg_total
    return geo.orthogonalize(R), t, xyz, cost


def lm_init_pcg(prob: BAProblem, cfg: EngineConfig, chi2_th: float = 5.991, lam0: float = 1e-4,
                cg_iters: int = 48, group=None):
    """The initial LM carry (R, t, xyz, lam, cost, cg_total) for solving in steps."""
    cost_of = _cost_fn(prob, cfg, chi2_th, group)
    R_in = geo.orthogonalize(prob.R)
    dev = prob.xyz.device
    return (R_in, prob.t, prob.xyz, ops.scalar(lam0, prob.xyz.dtype, dev), cost_of(R_in, prob.t, prob.xyz)[0],
            ops.scalar(0, torch.int32, dev))


def lm_steps_pcg(prob: BAProblem, cfg: EngineConfig, carry, chi2_th: float = 5.991, n_iters: int = 1,
                 cg_iters: int = 48, cg_tol: float = 1e-6, chunk: bool = True, group=None, seg=None):
    """Advance the LM carry by ``n_iters`` iterations (the arithmetic of
    ``solve_ba_pcg``: one chunk of the engine's asynchronous GBA). The
    engine bounds a chunk's stall by truncating CG (``cg_iters``) and
    loosening ``cg_tol``: a coarser camera solve per iteration, still held
    by the accept rule. ``seg``: ``segment_orders(prob, chunk)``, which a
    caller stepping one problem many times builds once (else each call
    builds it: two host reads)."""
    body = _lm_machinery(prob, cfg, chi2_th, cg_iters, cg_tol, chunk, group, seg)
    for _ in range(n_iters):
        carry = body(carry)
    return carry
