"""videos_per_s: videos scored in the window over the window's seconds (all
work and all time: the window closes when the last video enqueued is scored)."""


def read(ctx):
    done = [a for a in ctx.answers if a.vec is not None]
    return len(done) / ctx.window_s if done else None
