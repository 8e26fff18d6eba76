"""Host ms to issue one step of ``models/enhancer.build_enhance_fn`` (the
call, its NV12 glue and its launches), the mean over the untraced steps of
the window."""


def read(ctx):
    if ctx.system.span != "enhance" or not ctx.host:
        return None
    return 1e3 * sum(r.issue_s for r in ctx.host) / len(ctx.host)
