"""ddp.allreduce_ms: device time a step of the program's NCCL sum
all-reduces (`_sync_train_step`: the flat one of the gradients and
BatchNorm statistics, and the metrics'), from the trace's kernels named
`ncclDevKernel_AllReduce_Sum_*`. Left out: the benchmark's stop flag (a
max all-reduce of one float a step) and the profiler's `nccl:all_reduce`
annotation, which spans the same kernels. A kernel's time includes its
wait for the slowest rank to arrive, which the trace cannot split from
the transfer."""
KERNEL = "AllReduce_Sum"


def read(ctx):
    s = sum(d for name, _, d in ctx.trace.device_ops
            if name.startswith("nccl") and KERNEL in name)
    return 1e3 * s / ctx.steps if s > 0 and ctx.steps else None
