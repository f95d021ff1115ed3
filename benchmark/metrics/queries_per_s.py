"""queries_per_s (queries/s, host clock): statements completed with
correct rows in the window, over the window's length. The window opens
at the first send and closes at the first completion from --seconds on
(no statement is sent after --seconds): the server runs one statement
at a time, so a close at a completion leaves no statement's work half
counted, as a close at a fixed time would."""


def read(ctx):
    done = [s for s in ctx.statements
            if s.t_done <= ctx.t_close and not s.failed and not s.wrong]
    return len(done) / (ctx.t_close - ctx.t0)
