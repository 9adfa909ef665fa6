"""``launches_per_step.train``: device kernels that ran inside the
benchmark's ``train_epoch`` span of the traced epoch, over its steps. The
span ends with the epoch's loss read-back, which waits for the device, so
every kernel of the epoch's steps starts inside it and none of the
evaluation's does."""


def read(run):
    s = run.summary
    if s is None:
        return None
    span = s.span("pbench.train_epoch")
    if span is None or run.steps <= 0:
        return None
    return len(s.kernels_in(*span)) / run.steps
