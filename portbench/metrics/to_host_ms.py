"""to_host_ms: milliseconds a frame spends in the ``to host`` span
(``render.render``'s ``.cpu().numpy()``) after the frame's last device
operation that is not a memory copy has ended: the copy of the frame into
host memory and the calls around it, without the wait for the kernels.
Averaged over the frames that have the span (a frame without device
operations, as on the CPU, counts the whole span); None where none has."""


def read(rec):
    times = []
    for f in rec["frames"]:
        spans = [(end - ms / 1e3, end) for kind, _, ms, end in f["split"] if kind == "to host"]
        if not spans:
            continue
        start, end = spans[-1]
        compute = [e for name, _, e in f.get("kernels", ()) if not name.startswith("Memcpy")]
        if compute:
            start = max(start, min(max(compute), end))
        times.append((end - start) * 1e3)
    return sum(times) / len(times) if times else None
