"""SwinV2's window attention's share of its roofline, %: the least time a
frame's window-attention work takes on the card, the larger of its bytes at
``counts.PEAK_HBM_BYTES_S`` and its operations at ``counts.PEAK_BF16_FLOPS``
(the detector plug-in's ``window_attn_work``: q, k and v read once, the
output written once, the bias tables read once; q.k and P.V), over the
median per-frame device time of the spans ``swinv2.window_attn``
(``swinv2.window_attn_ms``). A program without that span gives None."""

from benchmark import counts, run


def read(ctx):
    ms = run.metric_reader("swinv2.window_attn_ms")(ctx)
    if ms is None or ms <= 0:
        return None
    flops, bytes_moved = run.detector(ctx["config"]).window_attn_work(ctx["config"])
    return 100.0 * counts.roofline_seconds(flops, bytes_moved) / (ms / 1e3)
