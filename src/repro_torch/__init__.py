"""repro_torch — the PyTorch/CUDA port of the repro package's accelerator half.

Layers (module names mirror the JAX package):
  repro_torch.configs  — architecture configs (gemma2-2b, rwkv6-1.6b,
                         zamba2-2.7b so far)
  repro_torch.models   — dense decoder LM, RWKV6 and the zamba2 hybrid (Mamba2
                         + shared attention): params as nested dicts of
                         tensors
  repro_torch.kernels  — hand-written CUDA kernels for Hopper (sm_90a), each
                         beside its plain PyTorch version
  repro_torch.optim    — AdamW
  repro_torch.data     — synthetic corpus, packing, batches
  repro_torch.runtime  — prefill / decode / greedy generation; train step
  repro_torch.launch   — serve and train entry points
  repro_torch.bridge   — numpy <-> torch param trees, for parity tests

Entry points run on "cuda" unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
