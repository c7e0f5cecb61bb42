"""`server.encode_ms`: the mean of the spans around the JPEG encode inside `ViewerServer.frame_jpeg` (`utils/jpeg.py::encode_frame`: device stages, copy, host entropy coder), in ms, over
the window of a traced run; each span is taken by the host clock from the
benchmark's own wrapper and closed by a sync on both sides."""


def read(ctx: dict):
    spans = ctx.get("spans", {}).get("server.encode_ms")
    return 1e3 * sum(spans) / len(spans) if spans else None
