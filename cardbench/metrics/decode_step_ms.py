"""decode_step_ms: the serving engine's own decode seconds over the
window (its ``decode_s`` gauge, host clock ended by the tokens' copy to
the host) over the window's decode steps."""


def read(r):
    steps = r.window.get("decode_steps")
    if not steps:
        return None
    return 1000.0 * r.window["decode_s"] / steps
