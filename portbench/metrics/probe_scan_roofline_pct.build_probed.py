"""The probed candidate scan's share of its roofline: the least time of
the work the scan needs (``portbench.roofline_probed.probed_scan``, from
the layer sizes and the configuration) over the device seconds inside the
traced build's probed scans."""

from portbench.roofline_probed import probed_scan


def read(ctx):
    c = ctx["counters"]
    device_s = c.get("probe_scan_device_s")
    if not device_s or not c.get("probed_layers"):
        return None
    cfg = ctx["config"]
    least = probed_scan(c["layer_sizes"], c["probed_layers"], c["ndim"],
                        c["k"], int(cfg["probes"]), int(cfg["probe_csize"]),
                        int(cfg["q_block"]))["least_s"]
    return 100.0 * least / device_s
