#!/bin/bash
# Planted faults in the CUDA A^T B, flash-attention, SSD, WKV and
# decode-attention kernels (four, four, six, three and four): each one is
# applied to a copy of src/, tests/ and chip_smoke.py in a temporary
# directory, then the card tests of that kernel run against the copy
# (tests/test_torch_tiled_matmul_cuda.py, which include the METG ladder's
# shapes, tests/test_torch_flash_attention_cuda.py,
# tests/test_torch_ssd_cuda.py, tests/test_torch_wkv6_cuda.py or
# tests/test_torch_decode_attention_cuda.py); for A^T B
# also a short METG ladder run, for the SSD backward and WKV chip_smoke.py.
# Every fault must fail the card tests; a fault on the METG path's fp32
# product must also stop the ladder with failed tasks, and an SSD or WKV
# fault must fail chip_smoke.py.  Prints,
# per fault, the ids of the card tests that failed, pytest's summary and
# the ladder's or chip_smoke.py's last line.  Exits 1 if a fault's pattern
# does not apply.  Names given as arguments run only those faults.
# Needs the card and nvcc.  Run from the repository root:
#
#     bash tests/cuda_planted_faults.sh [fault ...]
set -u
cd "$(dirname "$0")/.."
MM=src/repro_torch/csrc/tiled_matmul.cu
FA=src/repro_torch/csrc/flash_attention.cu
SSD=src/repro_torch/csrc/mamba2_ssd.cu
WKV=src/repro_torch/csrc/wkv6.cu
DA=src/repro_torch/csrc/decode_attention.cu
declare -A FILES FAULTS
# A^T B: the k loops stop one k-stage early (fp32 and bf16)
FILES[drop_last_k_slice]=$MM
FAULTS[drop_last_k_slice]='s/return (K + depth - 1) \/ depth;/return (K - 1) \/ depth;/'
# A^T B: bf16 output truncated instead of rounded to nearest
FILES[bf16_truncation]=$MM
FAULTS[bf16_truncation]='s/return __float2bfloat16(x);   \/\/ round to nearest even/return __float2bfloat16_rz(x);/'
# A^T B fp32: a drift of one part in 1e7 per k-stage (about one fp32 ulp)
FILES[drift_per_slice]=$MM
FAULTS[drift_per_slice]='s|    // end of the k-slice|    for (auto\& r : acc) for (float\& x : r) x *= 1.0000001f;|'
# A^T B fp32: operands rounded to TF32 (10 mantissa bits) as they are read
FILES[tf32_inputs]=$MM
FAULTS[tf32_inputs]='s|return \*reinterpret_cast<const float4\*>(p);   // operands as stored|float4 v = *reinterpret_cast<const float4*>(p); float* f = \&v.x; for (int i = 0; i < 4; ++i) f[i] = __uint_as_float((__float_as_uint(f[i]) + 0x1000u) \& 0xffffe000u); return v;|'
# flash bf16: P.V with P_hi only (the P_lo term dropped)
FILES[drop_p_lo]=$FA
FAULTS[drop_p_lo]='s|if (!probs_bf16) sm90::wgmma_rs<HD, 1>(o, plo\[kt\], dv, 1);   // P_lo . V||'
# flash bf16: the softcap through tanh.approx.f32 (~2^-11 relative error)
FILES[tanh_approx]=$FA
FAULTS[tanh_approx]='s|x = cap \* tanhf(x \* inv_cap);|{ float th; asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(x * inv_cap)); x = cap * th; }|'
# flash bf16: the last key tile of each block's band skipped
FILES[skip_last_key_tile]=$FA
FAULTS[skip_last_key_tile]='s/for (int it = 0; it < n_tiles; ++it) {/for (int it = 0; it < n_tiles - 1; ++it) {/'
# flash bf16: output truncated instead of rounded to nearest
FILES[bf16_out_truncation]=$FA
FAULTS[bf16_out_truncation]='s/return __float2bfloat16(x);   \/\/ round to nearest even/return __float2bfloat16_rz(x);/'
# SSD backward, stage 2: dS not carried to the chunk before (it stays 0;
# the walk from the last chunk back only)
FILES[drop_ds_carry]=$SSD
FAULTS[drop_ds_carry]='s|acc = fma4(av\[u\], acc, v\[u\]);   // carried to the next chunk|if (!BACK) acc = fma4(av[u], acc, v[u]);|'
# SSD forward, stage 2: the initial state ignored (the walk starts from 0)
FILES[ignore_initial_state]=$SSD
FAULTS[ignore_initial_state]='s|if (init)   // S_in\[0\], the initial state|if (false)|'
# SSD, stage 2's forward walk (the forward's, and the backward's S_in): the
# state stored after the chunk's update, not before (each chunk sees the
# state leaving it; the final state stays right)
FILES[ssd_state_after_update]=$SSD
FAULTS[ssd_state_after_update]='s|p\[(long long)c \* hdn4\] = acc;   // the value entering c|if (BACK) p[(long long)c * hdn4] = acc;|; s|acc = fma4(av\[u\], acc, v\[u\]);   // carried to the next chunk|acc = fma4(av[u], acc, v[u]); if (!BACK) p[(long long)c * hdn4] = acc;|'
# SSD forward, stage 3: Y without the inter-chunk term E o (C.S_in^T)
FILES[drop_inter_chunk]=$SSD
FAULTS[drop_inter_chunk]='s|const float et = sE\[m0 + g + 8 \* (i >> 1)\];   // E\[t\] scales C.S_in^T|const float et = 0.f;|'
# SSD backward, stage 3: d(dA) = dcum, the reverse in-chunk cumsum skipped
FILES[skip_reverse_cumsum]=$SSD
FAULTS[skip_reverse_cumsum]='s|from_f<T>(excl + run\[e\]);   // d(dA)\[t\]: the reverse cumsum|from_f<T>(dc[e]);|'
# SSD backward, every product: plain TF32, the lo terms of 3xTF32 dropped
FILES[tf32_only]=$SSD
FAULTS[tf32_only]='s|mma_tf32(s\[j\], al, bh); mma_tf32(s\[j\], ah, bl);   // the lo terms||'
# WKV, stage 2: the state stored after the chunk's update, not before (each
# chunk sees the state leaving it; the final state stays right)
FILES[state_after_update]=$WKV
FAULTS[state_after_update]='s|s\[(long long)c \* hdd4\] = acc;   // S_in\[c\], the state entering c||; s|acc = fma4(av\[u\], acc, v\[u\]);   // S_in\[c+1\] = a_c S_in\[c\] + dS_c|acc = fma4(av[u], acc, v[u]); s[(long long)c * hdd4] = acc;|'
# WKV, stage 3: the bonus term beta[t] v[t] dropped from y
FILES[drop_bonus]=$WKV
FAULTS[drop_bonus]='s|const float bt = sBeta\[tr + i\];|const float bt = 0.f;|'
# WKV, stage 1: k scaled by exp(cumw[Q-1]) without subtracting cumw[j]
FILES[k_decay_from_chunk_start]=$WKV
FAULTS[k_decay_from_chunk_start]='s|sK\[i\] \*= expf(wlast\[i % HD\] - sW\[i\]);|sK[i] *= expf(wlast[i % HD]);|'
# decode attention: p not rounded to the cache's type before P.V
FILES[p_unrounded]=$DA
FAULTS[p_unrounded]='s|p = Elem<E>::round(|p = (|'
# decode attention: the window one key wider (pos - t <= window)
FILES[window_one_wider]=$DA
FAULTS[window_one_wider]='s|long long lo = a.window > 0 ? p - a.window + 1 : 0;|long long lo = a.window > 0 ? p - a.window : 0;|'
# decode attention: the chunks' sums of exp added without rescaling each
# to the row's max
FILES[chunk_sums_unscaled]=$DA
FAULTS[chunk_sums_unscaled]='s|l += st\[2 \* c + 1\] \* expf(st\[2 \* c\] - mx);|l += st[2 * c + 1];|'
# decode attention: the key at the row's own position skipped
FILES[own_key_skipped]=$DA
FAULTS[own_key_skipped]='s|k.t1 = min(k.c0 + a.chunk - 1, k.hi);|k.t1 = min(k.c0 + a.chunk - 1, k.hi - 1);|'
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
for fault in $(if [ $# -gt 0 ]; then printf '%s\n' "$@"; else
                 printf '%s\n' "${!FAULTS[@]}" | sort; fi); do
  file=${FILES[$fault]}
  copy="$work/$fault"
  mkdir -p "$copy" && cp -r src tests pytest.ini chip_smoke.py "$copy/"
  sed -i "${FAULTS[$fault]}" "$copy/$file"
  if cmp -s "$file" "$copy/$file"; then
    echo "$fault: the fault did not apply"; exit 1
  fi
  case "$file" in
    "$MM") tests=tests/test_torch_tiled_matmul_cuda.py ;;
    "$FA") tests=tests/test_torch_flash_attention_cuda.py ;;
    "$WKV") tests=tests/test_torch_wkv6_cuda.py ;;
    "$DA") tests=tests/test_torch_decode_attention_cuda.py ;;
    *) tests=tests/test_torch_ssd_cuda.py ;;
  esac
  echo "== $fault ($(basename "$file"))"
  (cd "$copy" && PYTHONPATH=src python -m pytest -q -rf --noconftest -m cuda \
    "$tests" 2>&1 \
    | tee pytest.log | grep '^FAILED' | sed -e 's/ - .*//' -e 's/.*:://' \
    | tr '\n' ' '; echo; tail -1 pytest.log)
  if [ "$file" = "$MM" ]; then
    (cd "$copy" && PYTHONPATH=src timeout 300 python -m repro_torch.launch.metg \
      --sizes 256,4096 --seconds 0.02 --max-tasks 300 2>&1 | tail -1 \
      | cut -c1-300)
  fi
  if [ "$file" = "$SSD" ] || [ "$file" = "$WKV" ]; then
    (cd "$copy" && timeout 900 python chip_smoke.py 2>/dev/null | tail -1 \
      | cut -c1-400; echo "chip_smoke.py exit ${PIPESTATUS[0]}")
  fi
done
