"""Host calls that block on the device, per frame: the runtime's stream, device and event
synchronisations and its synchronous copies, counted by the profiler's names."""

NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def read(t):
    if not t.device:   # no device activity traced (a run without a card)
        return None
    if t.frames <= 0:
        return None
    return sum(t.host.get(n, (0, 0))[0] for n in NAMES) / t.frames
