"""Host ms a frame to issue the fused step
(``models/fused_encode.build_enhance_gop_fn``: its Python loop over the
frames and their launches), the mean over the untraced steps of the
window."""


def read(ctx):
    host = [r for r in ctx.host if "fn_s" in r.parts]
    if not host:
        return None
    return 1e3 * sum(r.parts["fn_s"] for r in host) / sum(r.frames for r in host)
