#!/bin/bash
# Planted faults in the CUDA A^T B kernel: each one is applied to a copy of
# src/ and tests/ in a temporary directory, then the card tests
# (tests/test_torch_tiled_matmul_cuda.py, which include the METG ladder's
# shapes) and a short METG ladder run against the copy.  Every fault must
# fail the card tests; a fault on the METG path's fp32 product must also
# stop the ladder with failed tasks.  Prints, per fault, the ids of the card
# tests that failed, pytest's summary and the ladder's last line.  Needs the
# card and nvcc.  Run from the repository root:
#
#     bash tests/cuda_planted_faults.sh
set -u
cd "$(dirname "$0")/.."
declare -A FAULTS=(
  # the loop over k stops one slice early
  [drop_last_k_slice]='s/for (int k0 = 0; k0 < K; k0 += BK)/for (int k0 = 0; k0 + BK < K; k0 += BK)/'
  # bf16 output truncated instead of rounded to nearest
  [bf16_truncation]='s/return __float2bfloat16(x);   \/\/ round to nearest even/return __float2bfloat16_rz(x);/'
  # a drift of one part in 1e7 per k-slice (about one fp32 ulp)
  [drift_per_slice]='s/acc\[i\]\[j\] += part\[i\]\[j\];/acc[i][j] = part[i][j] + acc[i][j] * 1.0000001f;/'
  # inputs rounded to TF32 (10 mantissa bits) as they are staged
  [tf32_inputs]='s/? to_f(X\[static_cast<size_t>(k) \* cols + c\])/? __uint_as_float((__float_as_uint(to_f(X[static_cast<size_t>(k) * cols + c])) + 0x1000u) \& 0xffffe000u)/'
)
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
for fault in "${!FAULTS[@]}"; do
  copy="$work/$fault"
  mkdir -p "$copy" && cp -r src tests pytest.ini "$copy/"
  sed -i "${FAULTS[$fault]}" "$copy/src/repro_torch/csrc/tiled_matmul.cu"
  if cmp -s src/repro_torch/csrc/tiled_matmul.cu \
      "$copy/src/repro_torch/csrc/tiled_matmul.cu"; then
    echo "$fault: the fault did not apply"; exit 1
  fi
  echo "== $fault"
  (cd "$copy" && PYTHONPATH=src python -m pytest -q -rf --noconftest -m cuda \
    tests/test_torch_tiled_matmul_cuda.py 2>&1 \
    | tee pytest.log | grep '^FAILED' | grep -oE '\[[^]]*\]' | tr '\n' ' ';
    echo; tail -1 pytest.log)
  (cd "$copy" && PYTHONPATH=src timeout 300 python -m repro_torch.launch.metg \
    --sizes 256,4096 --seconds 0.02 --max-tasks 300 2>&1 | tail -1 \
    | cut -c1-300)
done
