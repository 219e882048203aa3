"""Keyframe-block-partitioned bundle adjustment (port of
``dialog_tpu/optim/block_ba.py``).

The map's live keyframes, ranked by insertion number, split into B
contiguous blocks; every landmark is owned by the block of its reference
keyframe (or, when that keyframe was culled, by the lowest block among its
live observers). Each block's BA problem holds:

* variables: the block's keyframes and the landmarks it owns (ownership is
  disjoint, so write-backs never conflict);
* frozen context: other blocks' keyframes that observe owned landmarks
  (``cam_opt`` False), and landmarks owned elsewhere but observed by owned
  keyframes (``lm_opt`` False: their observations act as pose-only edges).
  Both directions of coupling keep each block step an exact
  block-coordinate descent on the joint robust cost.

Rounds alternate red-black: even blocks rebuild against the newest boundary
and are solved, then odd ones; only the active parity is solved. A block
solve is one ``local_ba.solve_ba`` over its problem: on the card that is
kernel C in its frozen-landmark mode (counted ``schur_reduce_frozen``) at
every LM iteration. The reference solves the blocks of a parity as one
``vmap`` (its einsum path); here they are a loop over the active blocks,
and with a ``torch.distributed`` group the active blocks are dealt out over
the ranks and their results combined by one ``all_reduce``.

A divergence on purpose (ROADMAP R1): a block takes at most ``cams_pb``
cameras, its owned keyframes first; the reference drops owned keyframes past
that cap without a word. The port keeps the same selection and counts the
owned keyframes left out (``build_block_problems``' fourth result,
``stats["block_ba_kf_dropped"]``).

Convergence: information crosses one block boundary per half-step, so
globally correlated error relaxes slowly; this is the map's parallel local
refinement, the pose graph and the global BA own the long-wavelength modes.
"""

from __future__ import annotations

import torch

from .. import ops
from ..config import EngineConfig
from ..containers import MapState
from ..distributed import all_sum
from .local_ba import BAProblem, bucket_observations, dedupe_row_landmarks, solve_ba

_LAST = 2**30   # the rank key of an invalid keyframe: after every live one


def _mark(n: int, idx: torch.Tensor) -> torch.Tensor:
    """bool[n]: True at the in-range entries of ``idx`` (duplicates allowed)."""
    idx = idx.reshape(-1).long()
    out = torch.zeros((n + idx.shape[0],), dtype=torch.bool, device=idx.device)
    return out.index_fill_(0, ops.drop_targets((idx >= 0) & (idx < n), idx, n), True)[:n]


def _block_partition(m: MapState, n_blocks: int):
    """(rank of each keyframe slot by insertion number, block of each
    keyframe (-1: invalid), block of each landmark (-1: none))."""
    kfs, lms = m.kfs, m.lms
    K = kfs.valid.shape[0]
    L = lms.xyz.shape[0]
    dev = kfs.valid.device
    seq_key = torch.where(kfs.valid, kfs.seq, _LAST)
    order = torch.argsort(seq_key, stable=True)
    rank_of = torch.zeros((K,), dtype=torch.int32, device=dev).scatter_(
        0, order, torch.arange(K, dtype=torch.int32, device=dev))
    n_live = kfs.valid.sum().to(torch.int32)
    blk_size = torch.clamp((n_live + n_blocks - 1) // n_blocks, min=1)
    kf_block = torch.where(kfs.valid, torch.clamp(rank_of // blk_size, max=n_blocks - 1), -1).to(torch.int32)

    # landmark ownership: the reference keyframe's block; a landmark whose
    # reference keyframe was culled re-anchors to the lowest block among its
    # live observers, or it would drop out of every block's objective
    lm_ref = torch.clamp(lms.ref_kf, 0, K - 1).long()
    ref_blk = torch.where(lms.valid & (lms.ref_kf >= 0), kf_block[lm_ref], -1)
    obs_all_ok = kfs.feat_valid & (kfs.obs_lm >= 0) & kfs.valid[:, None]
    blk_of_row = torch.where((kf_block >= 0)[:, None] & obs_all_ok, kf_block[:, None], n_blocks)
    obs_tgt = torch.where(obs_all_ok, kfs.obs_lm, -1)
    lm_obs_blk = ops.scatter_min(torch.full((L,), n_blocks, dtype=torch.int32, device=dev), obs_tgt, blk_of_row)
    lm_block = torch.where(ref_blk >= 0, ref_blk,
                           torch.where(lms.valid & (lm_obs_blk < n_blocks), lm_obs_blk, -1)).to(torch.int32)
    return rank_of, kf_block, lm_block


def _build_one(m: MapState, cfg: EngineConfig, b: int, rank_of, kf_block, lm_block, cams_pb: int, lms_pb: int):
    """Block ``b``'s problem: (BAProblem, cam_own [C], dropped observations
    and landmarks, owned keyframes left out)."""
    kfs, lms = m.kfs, m.lms
    K = kfs.valid.shape[0]
    L = lms.xyz.shape[0]
    O = cfg.max_obs_per_lm
    dev = kfs.valid.device
    owned_kf = kf_block == b
    owned_lm = lm_block == b

    # owned landmarks (variables, capacity lms_pb)
    own_ids = ops.nonzero_fixed(owned_lm, lms_pb, L)
    n_lm_over = torch.clamp(owned_lm.sum() - lms_pb, min=0)
    # boundary landmarks: seen by owned keyframes, owned elsewhere; frozen
    owned_rows = owned_kf[:, None] & kfs.feat_valid & (kfs.obs_lm >= 0)
    seen = _mark(L, torch.where(owned_rows, kfs.obs_lm, L))
    bnd_lm = seen & lms.valid & ~owned_lm & (lm_block >= 0)
    bnd_ids = ops.nonzero_fixed(bnd_lm, lms_pb, L)
    n_lm_over = n_lm_over + torch.clamp(bnd_lm.sum() - lms_pb, min=0)
    lm_ids = torch.cat([own_ids, bnd_ids]).to(torch.int32)
    lm_opt = torch.cat([own_ids < L, torch.zeros((lms_pb,), dtype=torch.bool, device=dev)])
    P2 = 2 * lms_pb

    # boundary cameras: other blocks' keyframes observing owned landmarks;
    # owners first (by touch count among equals), then boundary by touches
    in_own = _mark(L, own_ids)
    sel = in_own[torch.clamp(kfs.obs_lm, 0, L - 1).long()] & (kfs.obs_lm >= 0) & kfs.feat_valid
    touches = sel.sum(1).to(torch.int32)
    is_owner = owned_kf & kfs.valid
    is_boundary = ~owned_kf & kfs.valid & (touches > 0)
    prio = torch.where(is_owner, 2**20 + touches, torch.where(is_boundary, touches, 0))
    top_p, cam_slots = ops.top_k(prio, cams_pb)
    cam_valid = top_p > 0
    cam_slots = torch.where(cam_valid, cam_slots, K).to(torch.int32)
    safe_slot = torch.clamp(cam_slots, 0, K - 1).long()
    # boundary cameras are frozen context; the two globally oldest keyframes stay frozen (gauge)
    cam_opt = cam_valid & is_owner[safe_slot] & (rank_of[safe_slot] >= 2)
    cam_own = cam_valid & is_owner[safe_slot]
    kf_left_out = is_owner.sum() - cam_own.sum()

    # observation bucketing, shared with local BA
    inv = ops.scatter_set(torch.full((L,), P2, dtype=torch.int32, device=dev), lm_ids,
                          torch.arange(P2, dtype=torch.int32, device=dev))
    rows = kfs.obs_lm[safe_slot]
    rows_ok = cam_valid[:, None] & kfs.feat_valid[safe_slot] & (rows >= 0)
    li = torch.where(rows_ok, inv[torch.clamp(rows, 0, L - 1).long()], P2)
    li = dedupe_row_landmarks(li, P2)
    # an observation whose camera and landmark are both frozen adds nothing: it takes no O slot
    both_frozen = (~cam_opt)[:, None] & ~lm_opt[torch.clamp(li, 0, P2 - 1).long()]
    li = torch.where(both_frozen & (li < P2), P2, li)
    C = cams_pb
    obs_cam, obs_feat, obs_ok, n_obs_over = bucket_observations(li, P2, O)
    safe_cam = torch.clamp(obs_cam, 0, C - 1).long()
    feat = obs_feat.long()
    obs_uv = kfs.uv[safe_slot][safe_cam, feat]
    obs_oct = kfs.octave[safe_slot][safe_cam, feat]
    base = ops.scalar(cfg.scale_factor, torch.float32, dev)
    obs_w = torch.where(obs_ok, torch.pow(base, -2.0 * obs_oct.to(torch.float32)), 0.0)
    obs_ur = None   # mono configurations never gather the right-x
    if cfg.bf > 0:
        obs_ur = torch.where(obs_ok, kfs.u_right[safe_slot][safe_cam, feat], -1.0)
    prob = BAProblem(
        cam_slots=cam_slots, cam_opt=cam_opt, R=kfs.R[safe_slot], t=kfs.t[safe_slot], lm_ids=lm_ids,
        xyz=lms.xyz[torch.clamp(lm_ids, 0, L - 1).long()], obs_cam=obs_cam, obs_uv=obs_uv, obs_w=obs_w,
        obs_ok=obs_ok, obs_feat=obs_feat, obs_ur=obs_ur, lm_opt=lm_opt,
    )
    return prob, cam_own, n_lm_over + n_obs_over, kf_left_out


def _stack(probs: list) -> BAProblem:
    return BAProblem(*[None if xs[0] is None else torch.stack(xs) for xs in zip(*probs)])


def block_problem(probs: BAProblem, b: int) -> BAProblem:
    """Block ``b`` of a stacked problem."""
    return BAProblem(*[None if x is None else x[b] for x in probs])


def build_block_problems(m: MapState, cfg: EngineConfig, n_blocks: int, cams_pb: int, lms_pb: int):
    """Every block's ``BAProblem``, stacked on a leading block axis [B, ...]
    (C = ``cams_pb`` cameras, P = 2 ``lms_pb`` landmarks: owned, then
    boundary). Returns ``(probs, cam_own [B, C], n_dropped, n_kf_dropped)``:
    ``cam_own`` marks each block's own cameras (write-back targets),
    ``n_dropped`` counts observations cut at ``max_obs_per_lm`` and landmarks
    beyond ``lms_pb``, and ``n_kf_dropped`` the owned keyframes past
    ``cams_pb`` (R1: the reference has the first three only). Nothing is
    read back to the host."""
    part = _block_partition(m, n_blocks)
    out = [_build_one(m, cfg, b, *part, cams_pb, lms_pb) for b in range(n_blocks)]
    return (_stack([o[0] for o in out]), torch.stack([o[1] for o in out]), torch.stack([o[2] for o in out]).sum(),
            torch.stack([o[3] for o in out]).sum())


def _solve_blocks(probs: BAProblem, cfg: EngineConfig, iters: int, group=None):
    """Solve every block of ``probs`` (``solve_ba``, the mono Huber bound as
    the reference). With a process group each rank solves the blocks i with
    i % world == rank, writes them into zeros, and one ``all_reduce`` of R,
    t and xyz together gives every rank every block: sums with zeros, so
    the bits are those of the rank that solved. Returns (R [B,C,3,3],
    t [B,C,3], xyz [B,P,3])."""
    B = probs.cam_slots.shape[0]
    rank, world = 0, 1
    if group is not None:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)
    R, t, xyz = torch.zeros_like(probs.R), torch.zeros_like(probs.t), torch.zeros_like(probs.xyz)
    for b in range(rank, B, world):
        R[b], t[b], xyz[b], _ = solve_ba(block_problem(probs, b), cfg, iters=iters, chi2_th=cfg.chi2_mono)
    if group is not None:
        flat = all_sum(torch.cat([R.reshape(-1), t.reshape(-1), xyz.reshape(-1)]), group)
        R, t, xyz = (x.reshape(y.shape) for x, y in zip(torch.split(flat, [R.numel(), t.numel(), xyz.numel()]),
                                                       (R, t, xyz)))
    return R, t, xyz


def _write_back_blocks(m: MapState, probs: BAProblem, cam_own, R, t, xyz, parity: int = -1) -> MapState:
    """Fold the optimized owned cameras and landmarks into the map.
    Ownership is disjoint, so no two blocks write one slot. ``parity``
    restricts the fold to even (0) or odd (1) blocks (-1: all)."""
    K = m.kfs.valid.shape[0]
    L = m.lms.xyz.shape[0]
    B = probs.cam_slots.shape[0]
    dev = probs.cam_slots.device
    blk_on = torch.ones((B,), dtype=torch.bool, device=dev)
    if parity >= 0:
        blk_on = (torch.arange(B, device=dev) % 2) == parity
    cam_on = probs.cam_opt & cam_own & blk_on[:, None]
    tgt = torch.where(cam_on, probs.cam_slots, K).reshape(-1)
    kfs = m.kfs._replace(R=ops.scatter_set(m.kfs.R, tgt, R.reshape(-1, 3, 3)),
                         t=ops.scatter_set(m.kfs.t, tgt, t.reshape(-1, 3)))
    lm_on = (probs.lm_ids < L) & probs.lm_opt & blk_on[:, None]
    lm_tgt = torch.where(lm_on, probs.lm_ids, L).reshape(-1)
    lms = m.lms._replace(xyz=ops.scatter_set(m.lms.xyz, lm_tgt, xyz.reshape(-1, 3)))
    return m._replace(kfs=kfs, lms=lms)


def block_bundle_adjustment(m: MapState, cfg: EngineConfig, n_blocks: int = 8, rounds: int = 3, iters: int = 6,
                            cams_pb: int = 64, lms_pb: int = 4096, group=None, stats: dict | None = None) -> MapState:
    """Block-coordinate full-map BA. Each round runs two red-black
    half-steps: the blocks of one parity rebuild against the newest
    boundary, are solved and fold back, then the other parity's. Adjacent
    blocks never move at once (simultaneous updates chase each other's
    stale boundaries and oscillate), and blocks of one parity are
    independent. ``group``: a process group over which the active blocks
    are dealt out (every rank ends with the same map). ``stats`` gains
    ``block_ba_obs_dropped`` and ``block_ba_kf_dropped`` once per round
    (a host read each)."""
    for _ in range(rounds):
        for parity in (0, 1):
            probs, cam_own, dropped, kf_dropped = build_block_problems(m, cfg, n_blocks, cams_pb, lms_pb)
            if stats is not None and parity == 0:
                # once per round: both half-steps rebuild the same caps
                stats["block_ba_obs_dropped"] = stats.get("block_ba_obs_dropped", 0) + int(dropped)
                stats["block_ba_kf_dropped"] = stats.get("block_ba_kf_dropped", 0) + int(kf_dropped)
            # only the active parity's blocks are solved
            pp = BAProblem(*[None if x is None else x[parity::2] for x in probs])
            R, t, xyz = _solve_blocks(pp, cfg, iters, group)
            m = _write_back_blocks(m, pp, cam_own[parity::2], R, t, xyz)
    return m
