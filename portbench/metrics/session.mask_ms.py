"""`session.mask_ms`: the mean of the spans around `GaussianSplattingSession.evaluate_mask` (the positions' upload and the evaluation), in ms, over
the window of a traced run; each span is taken by the host clock from the
benchmark's own wrapper and closed by a sync on both sides."""


def read(ctx: dict):
    spans = ctx.get("spans", {}).get("session.mask_ms")
    return 1e3 * sum(spans) / len(spans) if spans else None
