"""The device's idle share of the untraced window: 100 x (1 - busy a frame x frames/s), the device's
busy seconds a frame (the union of its event intervals) from the stretch traced on the device alone,
the pace from the untraced window. A trace slows the host that paces the device (to about 0.7 of
its untraced rate with the device alone traced), so the traced stretch's own idle share
(``device.busy_s`` / ``window_s``) reads higher."""


def read(t):
    if not t.device:   # no device activity traced (a run without a card)
        return None
    if t.busy_frames > 0 and t.window_rate > 0:
        return 100.0 * (1.0 - t.busy_s / t.busy_frames * t.window_rate)
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
