"""The share of the traced window in which no kernel, copy or memset ran on
the card: 100 (1 - union of their intervals / window), from torch.profiler's
device trace."""


def read(run):
    if run.device is None or not run.device["window_s"]:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
