"""Warming the loop detection's first-use costs in set-up (the port's ``bench.warm_loop_paths``, copied)."""

from __future__ import annotations


def warm_loop_paths(eng) -> None:
    """Run loop detection's dispatch and evaluate once without changing the
    loop state: every field that ``dispatch``, ``take_pending`` and
    ``evaluate`` write is saved and restored. On the card this takes the
    detection's first-use costs (library handles, allocator blocks) out of
    the timed window."""
    if eng._vocab is None:
        return
    lc = eng._loop
    saved = (lc._pending_detect, list(lc._consistent), lc._eval_stamp, lc.last_eval_det_seq)
    lc._pending_detect = None
    lc.dispatch(eng.m, eng._bow_db, eng._vocab, max(eng.kf_count - 1, 0), stamp=eng.kf_count)
    det = lc.take_pending()
    if det is not None:
        lc.evaluate(det[0], det[1].cpu().numpy(), det[2].cpu().numpy(), stamp=det[3])
    lc._pending_detect, lc._consistent, lc._eval_stamp, lc.last_eval_det_seq = saved
