"""B3 calls per served field in the traced window: the
``fused_gram.kmv_sym.launches`` delta over the fields served. A count."""


def read(ctx):
    fields = sum(r["fields"] for r in ctx["requests"])
    calls = sum(r["launches"]["kmv_sym"] for r in ctx["requests"])
    return calls / fields if calls and fields else None
