"""dist.allreduce_ms_per_call: device ms of NCCL's kernels a traced call on
rank 0 (the all-reduce of the batch sum). Nothing in a one-card run."""


def read(ctx):
    s = ctx["summary"]
    if not s:
        return None
    secs = sum(v[0] for k, v in s["by_name"].items() if "nccl" in k.lower())
    return secs * 1e3 / ctx["traced"]["calls"] if secs > 0 else None
