"""`loader.load_s`: the seconds from `open_model` to the loader's last
drain of the streamed PLY at set-up, closed by a sync (host clock)."""


def read(ctx: dict):
    spans = ctx.get("spans", {}).get("loader.load_s")
    return spans[0] if spans else None
