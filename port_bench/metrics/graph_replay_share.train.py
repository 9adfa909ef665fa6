"""``graph_replay_share.train``: the share of the traced run's unprofiled
epoch's ``train.step`` spans that hold a ``train.replay`` span, the steps
the program replayed as a CUDA graph (1.0 where every step was). None
where the run was not traced, where the epoch is not there whole, and for
a program that records no ``train.replay`` span at all (one that does not
replay its steps); ``core/spans.py`` says which epoch is read."""

from port_bench.core import spans


def read(run):
    recs = spans.records(run)
    if recs is None or not any(r.name == "train.replay" for r in recs):
        return None
    found = spans.plain_epoch(run)
    if found is None:
        return None
    _, steps, kids = found
    replayed = sum(any(c.name == "train.replay"
                       for c in kids.get(s.index, ())) for s in steps)
    return replayed / len(steps)
