"""K2 and its set-up (``csrc/sampler.cu``) against their bytes' roofline:
the least time the bytes of the window's calls take at the HBM peak, over
the device time the profiler saw those kernels take.

:func:`watch` records the arguments of each of the window's K2 calls
(``oracle.dag.sample_slots``); :func:`read` counts their bytes from
those shapes after the window."""

from portbench.roofline import bytes_seconds, sampler_bytes

#: K2 and its set-up's kernels by the names the profiler gives them
K2_KERNELS = {"sample_slots", "link_log_weights", "dest_rows", "dest_index"}


def watch(run):
    """Record K2's calls in ``run.records["sampler_roofline"]``; returns
    the undo, or None where the program has no such call."""
    from sdnmpi_tpu_torch.oracle import dag

    inner = getattr(dag, "sample_slots", None)
    if inner is None:
        return None
    calls = run.records.setdefault("sampler_roofline", [])

    def record(weights, dist, src, dst, hops, *args, **kwargs):
        neigh = getattr(kwargs.get("tables"), "neigh", None)
        if neigh is not None:
            calls.append((int(weights.shape[0]), int(hops), dst, neigh,
                          kwargs.get("dst_nodes")))
        return inner(weights, dist, src, dst, hops, *args, **kwargs)

    dag.sample_slots = record
    return lambda: setattr(dag, "sample_slots", inner)


def call_bytes(v, hops, dst, neigh, dst_nodes) -> int:
    """The bytes of one recorded call (:func:`roofline.sampler_bytes`)."""
    import torch

    live = dst[dst >= 0]
    return sampler_bytes(v, int(neigh.shape[1]), int((neigh < v).sum()),
                         int(torch.unique(live).numel()),
                         0 if dst_nodes is None else int(dst_nodes.shape[0]),
                         int(live.numel()), hops)


def read(run):
    calls = run.records.get("sampler_roofline")
    device = run.trace.device_s(K2_KERNELS)
    if not calls or device <= 0:
        return None
    least = sum(bytes_seconds(call_bytes(*c)) for c in calls)
    return 100.0 * least / device
