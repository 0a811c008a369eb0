"""Channel-seconds of signal turned into planes per second: every call
completed in the window times its channel-seconds, over the window's wall
time (from its start to the end of its last call)."""


def read(run):
    return run.n_calls * run.channel_seconds / run.window_s
