"""Times the flash-attention op of one source tree at the served and trained
causal shapes of the port's models and at head dim 64, on the card.

    python3 chip_flash_ab.py SRC TAG

SRC is the `src` directory of the tree to time (this checkout's, or a
parent commit's unpacked with `git archive` into a directory that
.gitignore lists); TAG labels its lines.  Two trees are compared within
one machine by alternating them, each in its own process:

    for t in "parent/src parent" "src change" "src change" "parent/src parent"
    do python3 chip_flash_ab.py $t; done

Each line gives the median and the least of 5 CUDA-event means over a
shape's repetitions, after one warm-up call (which builds the kernel).
Inputs are seeded `randn`; the op is called as the models call it
(causal, with the shape's window and soft cap).
"""
import statistics
import sys

# name, dtype, B, S, Hq, G, q/k head dim, v head dim, window, softcap, reps
SHAPES = [
    ("gemma2 main", "bfloat16", 4, 4200, 16, 4, 256, 256, 4096, 50.0, 20),
    ("gemma2 main", "float32", 4, 4200, 16, 4, 256, 256, 4096, 50.0, 5),
    ("gemma2 serve", "bfloat16", 1, 4200, 16, 4, 256, 256, 4201, 50.0, 30),
    ("deepseek-7b", "bfloat16", 1, 4200, 32, 32, 128, 128, None, 0.0, 30),
    ("qwen2-vl", "bfloat16", 1, 4200, 16, 2, 128, 128, None, 0.0, 30),
    ("mla 192/128", "bfloat16", 1, 4200, 16, 16, 192, 128, None, 0.0, 30),
    ("zamba2 train", "bfloat16", 2, 1024, 32, 32, 80, 80, None, 0.0, 50),
    ("zamba2 train", "float32", 2, 1024, 32, 32, 80, 80, None, 0.0, 20),
    ("zamba2 serve", "bfloat16", 1, 4200, 32, 32, 80, 80, None, 0.0, 30),
    ("hd64 4200", "bfloat16", 1, 4200, 16, 8, 64, 64, None, 0.0, 30),
    ("hd64 4200", "float32", 1, 4200, 16, 8, 64, 64, None, 0.0, 10),
    ("hd64 1500", "float32", 1, 1500, 16, 8, 64, 64, None, 0.0, 30),
    ("hd64 2x448", "float32", 2, 448, 16, 8, 64, 64, None, 0.0, 50),
]


def main(src: str, tag: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.flash_attention import ops
    if not torch.cuda.is_available():
        raise SystemExit("chip_flash_ab: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, dt, b, s, hq, g, hd, hd_v, window, cap, reps in SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, s, hq, hd), (b, s, g, hd),
                                 (b, s, g, hd_v)))

        def call():
            return ops.flash_attention(q, k, v, window=window,
                                       logit_softcap=cap, scale=hd ** -0.5)

        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        print(f"[ab] {tag:6s} {name:12s} {dt:8s} ({b},{s},{hq}/{g},"
              f"{hd}/{hd_v}) w={window} cap={cap}: median "
              f"{statistics.median(times):.4f} ms min {min(times):.4f}",
              flush=True)
        del q, k, v


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
