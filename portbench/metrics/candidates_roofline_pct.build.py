"""The exact candidate scan's share of its roofline: the least time of the
work the scan needs for these inputs (``portbench.roofline
.candidate_scan``, from the layer sizes) over the device time of every
kernel that ran inside the candidates stage of the traced build."""

from portbench.roofline import candidate_scan


def read(ctx):
    c = ctx["counters"]
    device_s = c.get("candidates_device_s")
    if not device_s:
        return None
    least = candidate_scan(c["layer_sizes"], c["ndim"], c["k"])["least_s"]
    return 100.0 * least / device_s
