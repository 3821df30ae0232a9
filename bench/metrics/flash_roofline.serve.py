"""The flash attention kernel's share of its roofline while serving: the
least time of the calls made in the traced span (each call's FLOPs at the
bf16 peak or its bytes at the HBM rate, from the frozen cost arithmetic at
the prefill's shape), over the device time of the kernels named below.
The calls are the op's `.launches` over the span, which must equal the
prefill calls of the batches run; else nothing is read."""
from bench.harness import work

KERNELS = ("flash_fwd_tc", "flash_fwd_cuda_cores")


def read(run):
    if run.trace is None or not run.launches.get("flash"):
        return None
    m, s = run.model, run.traffic["prompt_len"]
    per_forward = work.layer_shape(m)[1]
    if per_forward * len(run.batches) != run.launches["flash"]:
        return None
    least = sum(per_forward * work.flash_least_s(
        b["b"], s, m["n_heads"], m["n_kv_heads"], m["head_dim"])
        for b in run.batches)
    spent = run.trace.kernel_seconds(KERNELS)
    return 100.0 * least / spent if spent > 0 else None
