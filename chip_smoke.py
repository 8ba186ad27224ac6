#!/usr/bin/env python
"""Chip smoke test of the PyTorch port (lvt_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — compiles lvt_tpu_torch/csrc/*.cu with nvcc for sm_90a.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                DSFVT shapes, with the tolerances below; times both. Kernel 2
                also at the rollout's batch sizes (b in 1, 8, 16 x live in
                64, 256; bf16, and fp32 at b=1) beside the library call and
                the bound. Kernels 1, 10, 2 and 6 also at the shapes of one
                tensor-parallel rank's shard (TPU.MESH_MODEL 2: 4 heads of
                128, 256 codes a sub-codebook), with times and bounds.
  4. main     — the generation path (PR-DVQVAE2 encode of example/*.png, DSFVT
                KV-cached rollout, decode) at full width with seeded random
                weights: batch 1 through scripts/generate_videos_torch.py as a
                user runs it (no VQ-VAE weights configured), and batch 8 with
                the VT in bf16, both sampled at temperature 1. Each slice is
                one replay of its CUDA graph (models/rollout_graph.py),
                captured at the first slice. Exactly 88 launches of kernel 1
                and 22,528 of kernel 2 in each rollout (a replay adds what its
                capture launched; the warm-up and the capture count none);
                rollout seconds, the capture's share of them, frames/s with
                and without it, peak memory. Kernel launch counts are read
                around this phase only.
  5. agree    — fp32, batch 2, full width: teacher-forced vt_logits (kernel 1
                causal and not) and the incremental decoder's teacher logits
                (kernel 2) on the card against the plain path on the CPU,
                and a control run of vt_logits with TF32 on that must
                fall outside the bound.
 5b. pth      — reference-layout .pth files at full width from a numpy seed
                (DSFVT's state dict and PR-DVQVAE2's netE, netG and netC,
                each wrapped as fvcore's {"model": state_dict}): batch 1
                through scripts/generate_videos_torch.py with the four files
                configured, with phase 4's checks and exact launch counts;
                the VT read from the same file on the card and on the CPU,
                its leaves equal and one slice's fp32 logits within PATH_TOL.
  6. train kernels — kernel 10 (the attention backward) and kernel 1 against
                their plain versions at DSFVT training shapes (nb=64), fp32
                and bf16, causal and not; device times; kernel 10's outputs
                bit-identical across two calls. Then both in bf16 at n in
                (48, 200, 256) x da in (64, 128) x causal, and kernel 10's
                dbias planes at nb in (1, 3, 64); kernel 1 bit-identical
                across two calls.
  7. fused kernels — kernels 7, 8 and 9 (the fused layer: forward with and
                without x2, FFN-half backward, attention-half backward)
                against their plain versions at nb=64, n=256, d=512, na=8,
                fp32 and bf16, causal and not; two calls bit-identical;
                device times beside the plain versions' and the unfused
                layer's (kernel 1 + the library's GEMMs; with kernel 10 in
                the backward); one bf16 call of each under torch.profiler,
                by __global__ function.
  8. train    — tools/train_net_torch.py's main on configs/vt/DSFVT.yaml at
                batch 64, bf16 compute, RMSprop, on latent videos written
                from a numpy seed, then --resume from its checkpoint, twice:
                with DSFVT's defaults (TPU.FUSED_LAYER True: the fused layer,
                20 + 4 steps, exactly 16 launches each of kernels 7, 8 and 9
                per step and none of kernels 1 and 10), and with
                TPU.FUSED_LAYER False (per-layer remat, 10 + 2 steps, exactly
                32 kernel-1 and 16 kernel-10 launches per step). Finite
                losses; device time by kernel of the last step
                (torch.profiler). The launch counts of kernels 7-10 are read
                around each run only.
  9. train agree — one fp32 loss and backward at batch 2, full width, with
                and without the fused layer: the loss and every gradient leaf
                on the card against the plain path on the CPU, fused against
                unfused on the card, and the unfused step with TF32 on, which
                must fall outside the bound.

 10. i8 kernels — kernels 3, 4 and 5 (decode attention over an int8 KV cache)
                at b in (16, 8, 1) (kernel 5: 16, 1, 256), na=8, R=256,
                da=128, live in (1, 64, 200, 256), bf16 and fp32 scales (kernel
                5: fp32 scales, fp32 and bf16 q), and kernel 11 (the int8-weight
                product) at b in (1, 8, 16) for DSFVT's three shapes and at K
                = 1,040, each against its plain version under the bounds
                below (kernel 11 bit-equal; kernels 3 and 4 also two calls
                bit-identical), with a control that must read above them;
                device times over inputs larger than the L2: kernels 3 and 4
                (and their fused entries) swept over b in (1, 8, 16) x live
                in (16, 64, 128, 256), each beside the bound and kernel 2's
                time at that shape; kernel 5 beside kernel 2's and swept over
                b in (1, 16, 256) x live in (1, 64, 200, 256), kernel 11
                beside torch._int_mm plus the scaling (yardsticks, never on a
                path).
 10b. i8 fold — kernels 3 and 4 with the quantization of q and of the new
                cache row folded in (the sampler's call) against the PyTorch
                sequence they replace: q8, sq, the written cache rows and
                scales bit-equal, the outputs within the kernels' bound, at b
                in (1, 8, 16) x live in (1, 64, 65, 256), fp32 and bf16, rows
                at and next to x.5 and tiny rows among them.
 11. main i8  — the quantized sampler at full width, batch 8, bf16, all 11
                sampled frames, greedy, through generate() (the graph) with
                TEST.VT_SAMPLER.KV_DTYPE / ATTN_IMPL / WEIGHT_DTYPE set: a
                native rollout for reference; then int8 KV + xla (PyTorch's
                ops, launches of kernels 2, 3, 4, 11 (0, 0, 0, 0)), int8 KV +
                pallas (kernel 3), int8 KV + pallas-live (kernel 4), int8 KV +
                pallas + int8-pallas weights (kernels 3 and 11). Launch counts
                set to 0 before each and read after: exactly 88 of kernel 1,
                22,528 of kernel 3 or 4 (all through the fused entry: one
                launch per layer and pixel that also quantizes q and writes
                the new cache row) and 90,112 of kernel 11 per rollout.
                Seconds with the capture's share, peak device memory and
                greedy agreement with the native rollout. The last slice of
                each rollout again, conditioned on the rollout's own frames,
                by the eager loop (and natively by a graph captured anew):
                codes equal.
 11b. slices  — one slice of the batch-8 bf16 rollout, greedy, natively and
                in the sampler modes phase 11 does not roll out (int8 KV with
                xla + int8 mm; int8 and int8-pallas weights), by the eager
                loop and by the slice's graph: codes bit-equal; each under
                torch.profiler (wall time, device busy share, activities per
                pixel, the graph's within a share ACTIVITY_GAP of the eager
                loop's); each hand-written kernel's launches in the graph's
                profile exactly those its capture recorded (kernel 1: the
                encoder's, eager).
 12. agree i8 — fp32, batch 1, full width: every quantized mode's teacher-
                forced logits on the card against the plain path on the CPU.
 12b. bench slice — bench.py's program (b = 1024, bf16, int8 KV, xla),
                one slice through its graph, and the same with mm_dtype
                int8: capture and replay seconds, device busy share, peak
                memory, codes in range.

 13. vq kernel — kernel 6 (nearest codebook entry, all sub-codebooks in one
                launch) against its plain version: N in (1, 8,192, 8,229),
                K=512, G=4 at Dc=64 and G=1 at Dc=256, fp32 and bf16 z,
                contiguous and strided; exact ties; indices equal except at
                float64-verified near-ties; a control (the plain version on
                bf16-rounded z) that must fail the same check; two calls
                bit-identical; device times of the grouped call beside the
                plain version, G calls of torch.cdist + argmin and the bound;
                the kernel's indices of the real z_e of example/*.png beside
                the plain version's.
 14. vqvae train — tools/train_net_torch.py's main on
                configs/vqvae/PR-DVQVAE2.yaml with no model override: batch 32,
                bf16 compute, the config's solver, 512 PNG frames of 64x64
                written from a numpy seed, 8 workers, 20 steps + 4 after
                --resume. Exactly 1 kernel-6 launch per step; finite loss
                terms; the EMA codebook moved, its running_size holds the
                expected mass, and the resumed run starts from the saved one.
 15. vqvae agree — fp32, batch 4, full width: loss terms, every gradient leaf,
                the new EMA state and the indices on the card (kernel 6)
                against the plain path on the CPU; a TF32 control that must
                read above the bounds.
 16. probe kernel — kernel 12 (decode attention with an unquantized q over
                int8 K/V) against its plain version at the probe tool's shape
                and DSFVT's, bf16 and fp32, live in (1, 64, 200, 256), with a
                control (kernel 3's scheme) that must read above the bound;
                device times swept over da in (16, 128) x b in (1, 16, 256) x
                live in (1, 64, 200, 256); tools/probe_decode_kernel_torch.py's
                timing run, beside kernels 2 and 3.
 17. eval     — tools/train_net_torch.py --eval-only at full width on a test
                set of 2 videos x 16 PNG frames of 64x64 written from a numpy
                seed (bair_test_seq's layout). Stage 1: PR-DVQVAE2 from phase
                14's OUTPUT_DIR, MSE and the 2 x 16 latent files (4, 16, 16)
                of CodesExtractor, exactly one launch of kernel 6 a video
                (encode_indices' default on the card since phase 19's count
                on a trained codebook); seconds, device busy share, peak
                memory.
                Stage 2: DSFVT from phase 8's fused OUTPUT_DIR over those
                latents with BitsEvaluator, VTSampler and FVDEvaluator, the
                paired VQ-VAE from phase 14's: bits/dim, FVD_stub, every
                sampled video's codes and PNGs, exactly 256 launches of
                kernel 7 per video (bits, fused layer) and 88 of kernel 1 and
                22,528 of kernel 2 per rollout, one rollout capture for the
                whole run; seconds of bits, of the logits' host transfer and
                of sampling apart. fp32 agreement, card vs the plain path on
                the CPU: 2 videos' MSE (1e-4 relative) and latents (near-ties
                only), 1 video's bits/dim (6e-5), i3d_apply at (2, 16, 224,
                224, 3) on seeded .npz weights (1e-4 of the largest logit).
                EvalHook: 4 fused DSFVT steps at TEST.EVAL_PERIOD 2 evaluate
                twice (the storage holds both, metrics.json the last), one
                rollout capture each.

 18. data parallel — engine.launch worlds, each rank on its rows of the
                global batches for 3 steps (the last profiled): DSFVT at full
                width, fused (kernels 7, 8, 9; 16 videos), and PR-DVQVAE2 as
                it stands (kernel 6; 32 frames). (a) 2 ranks on the one card
                over gloo, (b) NCCL at one rank per card (up to 4). On rank 0
                a one-process Trainer takes each step from the same state on
                the whole batch: the averaged gradient, the params and the
                model state within GRAD_TOL / GRAD_TOL_WHOLE (bit-equal at
                one NCCL rank), the codes of rank 0's frames under the
                near-tie rule; the ranks' params and model state bit-equal
                after every step; exact launches per rank; s/step,
                videos/s and frames/s for the global batch, the gradient
                average's share of the step, peak memory, per rank. Then,
                at two ranks or more, one greedy video a rank through
                generate_sharded (kernels 1 and 2 in the rollout's graph),
                each equal to it generated alone. Then the 2 gloo ranks as
                a tensor-parallel world, data 1 x model 2 (TPU.MESH_MODEL 2):
                2 unfused bf16 DSFVT steps at global batch 8 and 2
                PR-DVQVAE2 steps at 32 (the codebook split over its codes,
                kernel 6), each held on rank 0 to a one-process Trainer from
                the same state (the gathered gradient within TP_OWN_ROUNDING
                of bf16's own rounding, the params by the gradient rule, the
                codes under the near-tie rule); one fp32 loss + backward of
                DSFVT held to the whole model by the gradient rule with its
                TF32 control; one fp32 greedy b = 8 slice through the eager
                sampler, its codes equal to one rank's or differing only at
                logit near-ties; exact launches per rank, seconds, the
                collectives' share of a step.

 19. e2e      — the native IO library (lvt_tpu_torch/native) must build and
                load. tools/e2e_demo_torch.py's main at its defaults, full
                width, in both modes (BAIR: PR-DVQVAE2 -> DSFVT on 64 seeded
                moving-squares videos; class-conditional: K-DVQVAE -> KDSFVT,
                CLASS_NUM 600, on 3 classes x 22), but 30 + 30 steps at batch
                16, every count set to 0 before each mode: each stage's
                seconds and launches, held to _e2e_expected (kernel 6 a VQ-VAE
                step, kernels 7, 8, 9 16 a VT step, kernel 7 256 a video of
                bits/dim, kernels 1 and 2 88 and 22,528 a rollout); losses at
                start and end, MSE, bits/dim; codes in range, decoded frames
                finite in [0, 255], the class-conditional rollouts differ;
                kernel 6 against the plain fp32 search on every frame under
                the trained codebook, every difference a float64 near-tie.
                scripts/convert_kinetics_torch.py's process_video
                --preprocess device on 64 seeded 240x320 frames (ffmpeg
                stubbed), against PIL (PIL_MAX_STEPS, PIL_BEYOND_SHARE);
                center_crop_resize card vs CPU, its device time against the
                per-frame PIL loop.
                scripts/generate_videos_torch.py --img-size 64 on seeded
                96x128 priming frames (88 + 22,528 launches). PR-DVQVAE2's
                steps through the loader with the native reader and with PIL
                (tools/bench_pipeline_torch.py): s/iteration and data_time;
                the loader alone and each PNG decoder alone on the host.

 20. geometries — the other shipped geometries at full width (d = 512, 8
                heads of 128, 8 + 8 layers), as their files stand. DSSVT (4
                slices of 16 x 8 x 8) and DSTSVT (16 slices of 4 x 8 x 8),
                every slice holding primed positions: b = 8 bf16 greedy
                rollouts through tools/bench_sample_torch.py's run, native
                (kernels 1, 2) and one int8 mode each (DSSVT: int8 KV + pallas
                + int8-pallas weights, kernels 3 and 11; DSTSVT: pallas-live,
                kernel 4); the first call (with the graph's capture) and
                GEO_ITERS timed calls, every count set to 0 just before and
                read just after, held exactly to _geo_rollout_expected; the
                graph's node count and capture seconds, replay seconds a
                slice, frames/s, peak memory; codes in range, primed
                positions kept, slice 0 of the graph equal to the eager
                loop's. fp32, b = 1, TF32 off, in DSFVT, DSSVT and DSTSVT:
                logits_for_entire_video_incremental (kernels 1 and 2) against
                logits_for_entire_video (kernel 7) on the card within
                GEO_EXACT_TOL, and the card's logits_for_entire_video against
                the CPU's within PATH_TOL, with exact launches. Training
                through tools/train_net_torch.py: DSSVT (4-frame clips) and
                DSTSVT at the configs' batch of 64, fused and bf16, on seeded
                latent videos (kernels 7, 8, 9 exactly 16 a step), and
                Base-VQVAE (RGB channels, seeded PNG frames, batch 32;
                kernel 6 once a step), GEO_TRAIN_STEPS steps each: finite
                losses, Base-VQVAE's falling, s/step and peak memory; the
                example frames through the trained Base-VQVAE, kernel 6's
                indices against the plain search under the near-tie rule,
                decoded. tools/bench_train_torch.py --steps 5 (its JSON line,
                exact launches).

 21. tools    — DSFVT at full width through the last ported reference tools,
                every count set to 0 just before each run and read just
                after, held exactly: tools/quality_int8_torch.py (QI_ITERS
                fused bf16 training steps at batch 64, the native and int8
                cached teacher passes of QI_EVAL videos beside the anchor,
                five b = QI_SAMPLE rollouts, FVD_stub); tools/mfu_torch.py
                at batch 64, fused, unfused with TPU.REMAT_POLICY "dots" and
                "qkv", and fused with SOLVER.OPT_STATE_DTYPE bfloat16, then
                --sample --kv native --batch 8 --measure (the sampler's
                roofline beside a measured rollout), the unfused "" remat
                beside them;
                tools/soak_train_torch.py (a child SIGKILLed once its second
                checkpoint is on disk, resumed there in a second child whose
                launches it reports; cadence and pruning); the profiler hook
                (TorchProfiler) on 3 fused steps at batch 16, its trace read
                by tools/trace_summary_torch.py.

 22. sampler modes — the int4 KV cache and multi-stream rollouts at DSFVT's
                full width, bf16, greedy unless stated, each rollout the last
                slice of a seeded video of b = 8 through sample_video and the
                slice's CUDA graph, every count set to 0 just before and read
                just after, held exactly to _modes_expected (kernel 1 8, and
                in each of S streams kernel 2 or 3 once a layer and pixel).
                Streams 1, 2 and 4 natively, 1 and 2 with int8 KV + pallas
                (kernel 3; STREAM_RUNS), the graph's S parallel branches: at
                S > 1 codes equal to the graph's eager warm-up on the S
                streams and to one-stream eager rollouts of each block of
                b / S rows; agreement with the one-stream b = 8 rollout; the
                graph's nodes, a replay's seconds and busy share (the union
                of the device activities over the streams). A temperature
                rollout at 2 streams: codes and the generator's state equal
                the eager loop's from the same state. int4 KV: codes equal the
                eager loop's, agreement with the native rollout, the cache's
                bytes exactly half of int8's; one fp32 video's teacher logits
                (logits_for_entire_video_incremental) on the card against the
                CPU's within MODES_LOGIT_TOL (half the int4 gap at a
                near-tie), the int4 and int8 gaps to native; one slice of
                bench.py's program at b = 1024 with --kv int4: capture and
                replay seconds, peak memory.

 23. item 8   — ROADMAP item 8's three pieces at full width. (a) Before the
                side processes start, alone on the card: one slice's
                subscale_context_encode of DSSVT and DSTSVT (bf16) and DSFVT
                (fp32) at b = CTX_B = 1024 in every LVT_CTX_IMPL formulation
                (gather_sum, chunk, chain, onehot, minor, auto): ms (CUDA
                events around eager calls), peak memory above the inputs
                beside _ctx_predicted_bytes, the auto choice (chain in all
                three, its peak under a quarter of gather_sum's), the gap to
                gather_sum (fp32 CTX_FP32_TOL; bf16 S roundings of sum|rows|).
                (b) After phase 17: the per-slot table backward (one-hot
                products) against autograd through the plain gather at DSFVT
                and DSTSVT b = 64 (fp32 within CTX_GRAD_TOL), timed in fp32
                and bf16 beside it and beside per-slot index_put_ sums (a
                yardstick); fused bf16 train steps of each at b = 64 with the
                three backwards in turns (medians, peak memory, exactly 16
                launches of kernels 7, 8, 9 a step); the UNet at b = 8
                on 16 x 16 codes, card vs CPU in train and eval mode (fp32,
                TF32 off, UNET_TOL); tests/test_torch_gan.py's toy GAN through
                GanTrainer on the card, 400 iterations: 5 supervised, 395 D
                and 196 G steps exactly, the toy learning.

Order: 1, 2, then the phases that time kernels alone on the card (3, 10,
10b, 6, 7, 16), then 4, 5, 5b, 13 (the generation models loaded), 23a;
then phases 18 to 22 start in two side processes (18 then 22; 20, 21 then
19) beside 11, 11b, 12, 12b, 8, 9, 14, 15, 17, 23b in the main process, whose
times are therefore taken with the card and the host shared (see SIDE_GROUPS). Phases
8 and 14 keep their OUTPUT_DIRs for phase 17. The line before the last is
{"kernels": [...]}, each kernel with its main-path launches, phase 17's
("eval_launches"), phase 18's per rank of each world ("dp_launches") and
of its tensor-parallel world ("tp_launches"), phase 3's at one rank's shard
("tp_shard"),
phase 19's per run ("e2e_launches"), phase 20's per run
("geometry_launches"), phase 21's per run ("tools_launches") and phase 22's
per run ("sampler_modes_launches"); the last line is {"ok": true,
"device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, |kernel - plain| on the same inputs (kernel 2; kernels 1 and
# 10 take fwd_tol and bwd_tol below):
#   fp32: sums in another order only.
#   bf16: plus one rounding of the output to bf16 and of P to bf16 at a
#   boundary the two versions may cross differently (2^-7 relative).
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2 ** -7)}  # (abs, rel)
# whole path, fp32, card vs CPU: 16 layers of GEMMs summed in other orders
# (sound runs read ~3e-6 at |logits| <= 2.6). Phase 5 also runs vt_logits
# once with TF32 allowed and fails unless that control reads above the bound,
# so a path whose precision drops below fp32 cannot pass.
PATH_TOL = 2e-5
# kernel 10's dbias, |kernel - plain|: fp32 in both dtypes, a sum over nb
# blocks of fp32 terms taken in another order (1e-4 + 1e-5 relative)
DBIAS_TOL = (1e-4, 1e-5)
PTH_SEED = 52  # numpy seed of phase 5b's reference .pth files
# the generation runs of phase 4 sample from random weights: DSFVT.yaml names
# the reference's .pth VQ-VAE files, which are not in the repository (phase 5b
# writes its own)
NO_VQ_WEIGHTS = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", ""]


def fwd_tol(dtype, v):
    """Kernel 1's output, |kernel - plain|: fp32 as TOL; bf16 one rounding
    of the output (2^-7 relative) plus P rounded to bf16 on the other side
    of a boundary: the two versions' fp32 p may differ by an fp32 ulp, and
    where that straddles a bf16 boundary the term p * v moves by
    ulp_bf16(p) * |v| <= 2^-8 * max|v| (p <= 1). At nb=64 (131,072 rows)
    such rows land on small outputs, beyond TOL's relative part."""
    if dtype == "float32":
        return TOL[dtype]
    return (2 ** -8 * float(v.float().abs().max()), 2 ** -7)


def bwd_tol(dtype, ref):
    """Kernel 10's dq, dk, dv, |kernel - plain|: fp32 as TOL; bf16 one
    rounding of the output (2^-7 relative) plus one bf16 rounding at the
    output's largest value (2^-8 of it): where the two versions' fp32 dp
    land on either side of a bf16 boundary, one rounded ds term of
    |ds| up to ~4 moves a dq or dk sum by up to ulp(ds) * |k| / sqrt(da)."""
    if dtype == "float32":
        return TOL[dtype]
    return (2 ** -8 * float(ref.float().abs().max()), 2 ** -7)


# train agree, fp32: per gradient leaf, ||card - cpu|| / ||cpu|| (Frobenius;
# the denominator floored at 1e-2 of the largest leaf norm, for leaves whose
# gradient cancels to float noise). The gradient of the VT is not smooth in
# its inputs: a forward that moves by fp32 rounding flips ReLU gates whose
# input sits near 0, and each flip moves one FFN column by a whole token's
# share. On the CPU, scaling every weight by 1 + 1e-6 N(0, 1) (the size of
# the card's fp32 logits error) moves the worst leaf by 3.5e-3, and by 1e-3
# moves it by 7.6e-2 (TF32's logits error is ~1e-3 relative). The bound
# sits between; the TF32 control must read above it. The whole gradient
# (all leaves as one vector, same relative measure) averages the flips out
# and separates the two further: its bound, GRAD_TOL_WHOLE, holds too.
GRAD_TOL = 2e-2
GRAD_TOL_WHOLE = 5e-3
TRAIN_STEPS, RESUME_STEPS = 20, 4  # the fused run; the unfused run takes half

def peaks():
    """(bytes/s, {dtype: operations/s}): the NVIDIA H100 SXM peaks that are
    the roofs of bound_ms, from lvt_tpu_torch/utils/device_specs.py (read
    when called: this module imports nothing of the port)."""
    from lvt_tpu_torch.utils.device_specs import PEAK_BYTES, PEAK_FLOPS

    return PEAK_BYTES, PEAK_FLOPS


def bound_ms(dtype, nbytes, flops):
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate for their type, whichever is
    larger. Returns (ms, "bytes" or "operations")."""
    peak_bytes, peak_flops = peaks()
    tb, tf = 1e3 * nbytes / peak_bytes, 1e3 * flops / peak_flops[dtype]
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fused_tol(dtype, ref, summed=False):
    """Kernels 7, 8 and 9, |kernel - plain| against the output's largest
    value. fp32: sums of up to 3,072 terms in another order (2e-5), and for
    the weight and bias gradients sums over 16,384 rows (1e-4). bf16: one
    rounding of the output (2^-8) plus intermediates (qkv, P, f, ds, dqkv)
    that the two versions' fp32 values put on either side of a bf16
    boundary; each moves an output by a bf16 ulp of one term: 2^-6."""
    rel = 2 ** -6 if dtype == "bfloat16" else (1e-4 if summed else 2e-5)
    return (rel * max(float(ref.float().abs().max()), 1e-3), 0.0)

# Kernels 3 and 4, |kernel - plain|. Both integer products are exact, so the
# two differ only where exp or the order of the softmax's fp32 sum leaves a
# weight on the other side of x.5: it rounds one step apart and moves the
# outputs of that (batch row, head) by i8_weight_step * |v8|. Bound per output:
# I8_FLIPS such steps at |v8| = 127, plus 1e-5 of the head's largest output
# (the scale itself differs by ulps), plus for bf16 outputs one bf16 ulp
# (2^-7 relative). And at most I8_ROWS_OFF of the (batch row, head) pairs may
# differ by more than that rounding part. Control: the plain version of the
# other kernel (per-row against per-tile quantization, another rounding of
# the same attention) must break the second bound.
I8_FLIPS, I8_ROWS_OFF = 2, 0.05
# Kernel 5 keeps everything in fp32: sums in another order, 1e-5 of the
# largest output (+ one bf16 ulp on bf16 outputs). Control: its plain version
# with the weights rounded to bf16 before the V product (the sampler's own
# rounding point) must read above it.
K5_TOL = 1e-5
# Kernel 11: the integer sum is exact and the scale arithmetic IEEE on both
# sides: fp32 outputs within 1e-6 of the largest (bit-equal in practice).
# Control: the sampler's other weight mode, (y @ W8) * s with no activation
# rounding, must read above it.
K11_TOL = 1e-6
# Quantized sampler, fp32, card vs the plain path on the CPU, teacher-forced
# logits of one slice. Quantization amplifies fp32 noise: a value within the
# two sides' rounding difference of x.5 rounds one step apart, the step moves
# everything after it by ~1e-3 relative, and later roundings then part at a
# far higher rate. On the CPU (tools/probe_int8_noise_torch.py), scaling every
# weight by 1 + 1e-6 N(0, 1) moves the int8-KV logits by 0.18 of the mode's own gap to the native sampler (root
# mean square; 0.41 at the maximum) and, with the activations quantized for
# kernel 11 as well, by 0.53 (0.73). The card's fp32 noise against the CPU is
# smaller than that: it read 0.12 (int8 KV + pallas) and 0.34 (pallas-live,
# whose own gap is a third of pallas's in root mean square: finer weight
# steps, the same K and V steps). So the bound is a share of the mode's gap
# in root mean square; the control, the native logits on the card against the
# mode's on the CPU, reads the whole gap. The kernels themselves are held to
# their plain versions in phase 10, far tighter.
# The modes with int8 weights and no activation rounding (weight_dtype
# "int8", native KV) quantize the same weights on both sides (a true division,
# correctly rounded on both) and amplify nothing: the native share holds them.
AGREE_I8 = {"native": 0.6, "int8": 0.6, "int8-pallas": 0.85}  # by WEIGHT_DTYPE
# greedy codes of an int8 rollout against the native one, bf16, random
# weights: the logits are nearly flat, one flipped argmax changes everything
# after it, and chance agreement is 1/512. Measured 0.87 to 0.88 of all
# sampled codes (0.94 to 0.96 of the first sampled frame) in the three modes;
# the floor only says that the rollouts track each other far above chance.
GREEDY_FLOOR = 0.5

# Kernel 6 returns indices: equal to the plain version's, or differing only
# at near-ties (lvt_tpu_torch/ops/vq.py index_differences: the float64
# distances of the two codes within NEAR_TIE_ULPS fp32 ulps of the sums that
# form them, ||z||^2 + ||c||^2): the two versions sum in other orders, which
# can decide such a choice and no other. At most NEAR_TIE_SHARE of the rows
# may differ so. Control: the plain version on bf16-rounded z must fail.
# vqvae agree, fp32, card vs CPU: loss terms 1e-5 relative; gradients by the
# relative-Frobenius measures of the VT's train agree, both held to GRAD_TOL:
# ReLU gates near 0 flip under fp32 noise here too, and 28 leaves average
# fewer flips out than the VT's 300, so the whole gradient reads what the
# worst leaf reads (the card 2.9e-3 per leaf and 2.1e-3 whole; the TF32
# control, which must read above the bound, 0.157 and 0.112). The new EMA
# state within 1e-5 of its largest value on every code no differing index
# touches.
# Indices there: every difference a verified near-tie, and at most 3 per 1000.
# A freshly initialised codebook has entries within 1/512, so the two nearest
# codes of a row lie ~1e-3 apart at distances of ~3: fp32 ulps (2.4e-7) decide
# about 0.5 rows per 1000, where the seeded trained-scale inputs of phase 13
# read none.
VQ_AGREE_SHARE = 3e-3
VQ_TRAIN_STEPS, VQ_RESUME_STEPS, VQ_FRAMES = 20, 4, 512

N_PRIME, T_FRAMES = 5, 16
BENCH_BATCH = 1024  # bench.py's default batch (its program: int8 KV, attn_impl "xla")
# __global__ templates of csrc/fused_layer.cu that phase 7 reports by their
# template argument (gemm_nt_wgmma's epilogue, ln_rows_bf16's input type)
TEMPLATE_NAMES = ("gemm_nt_wgmma", "ln_rows_bf16")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def host_ms(calls, iters):
    """Time per call with the host's share: CUDA events around `iters`
    eager calls, cycling through `calls`."""
    import torch

    for f in calls:
        f()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(calls, iters):
    """Device time per call: `iters` calls, cycling through `calls`, captured
    in one CUDA graph and replayed between two CUDA events, so the host's
    per-call cost drops out."""
    import torch

    for f in calls:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def time_both(card, kernel_calls, plain_calls, iters, what=""):
    """(kernel device ms, plain device ms) per call, printed beside the
    per-call times with the host's share. The calls cycle through input
    sets that together exceed the 50 MB L2, as the rollout's calls find
    their inputs mostly outside it."""
    kd, pd = device_ms(kernel_calls, iters), device_ms(plain_calls, iters)
    kh, ph = host_ms(kernel_calls, iters), host_ms(plain_calls, iters)
    print(f"  time {what}[{card}]: device kernel {kd:.4f} ms, plain {pd:.4f} ms; "
          f"per call with host kernel {kh:.4f} ms, plain {ph:.4f} ms")
    return kd, pd


def sdpa_mask(bias, dtype, causal):
    """The bias (and a causal -inf) as scaled_dot_product_attention's
    attn_mask, (1, na, n, n) in q's dtype."""
    import torch

    mask = bias.to(dtype)[None]
    if causal:
        n = bias.shape[-1]
        mask = mask.masked_fill(torch.ones((n, n), dtype=torch.bool,
                                           device=bias.device).triu(1), float("-inf"))
    return mask


def library_fwd_ms(sets, causal, iters):
    """Device time of torch.nn.functional.scaled_dot_product_attention on
    kernel 1's inputs: the library's one call for the same function, except
    that it rounds P where its own kernels choose. A yardstick only: the port
    never calls it."""
    import torch.nn.functional as F

    masks = [sdpa_mask(x[3], x[0].dtype, causal) for x in sets]
    return device_ms([lambda x=x, m=m: F.scaled_dot_product_attention(x[0], x[1], x[2],
                                                                      attn_mask=m)
                      for x, m in zip(sets, masks)], iters)


def library_bwd_ms(sets, causal, iters):
    """Time of the autograd backward of scaled_dot_product_attention (dq, dk,
    dv and the mask's gradient) on kernel 10's inputs, by CUDA events around
    eager calls (device-bound at these shapes). A yardstick only."""
    import torch
    import torch.nn.functional as F

    calls = []
    for q, k, v, bias, g in sets:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias.to(q.dtype))]
        out = F.scaled_dot_product_attention(*leaves[:3],
                                             attn_mask=sdpa_mask(leaves[3], q.dtype, causal))
        calls.append(lambda out=out, leaves=leaves, g=g: torch.autograd.grad(
            out, leaves, g, retain_graph=True))
    return host_ms(calls, iters)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's kernels need a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from lvt_tpu_torch.ops._lib import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    print(f"build: {time.perf_counter() - t0:.2f} s ({LIBRARY.build_seconds:.2f} s nvcc) "
          f"-> {os.path.relpath(LIBRARY.path, ROOT)}")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas: " + line.strip())


def _err(k, p, dtype, tol=None):
    atol, rtol = tol or TOL[dtype]
    diff = (k.float() - p.float()).abs()
    ok = bool(((diff <= atol + rtol * p.float().abs()) & k.float().isfinite()).all())
    return float(diff.max()), ok


def phase_kernels(card):
    import torch

    from lvt_tpu_torch.ops.attention import attention_core_plain, block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda, decode_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}

    nb, na, n, da = 16, 8, 256, 128
    err1, t1 = 0.0, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        sets = [[torch.randn((nb, na, n, da), generator=g, device=dev).to(dt) for _ in range(3)]
                + [0.5 * torch.randn((na, n, n), generator=g, device=dev)] for _ in range(3)]
        for causal in (False, True):
            q, k, v, bias = sets[0]
            out = block_attention_fwd_cuda(q, k, v, bias, causal)
            ref = attention_core_plain(q, k, v, bias, causal)
            torch.cuda.synchronize()
            e, ok = _err(out, ref, dtype, fwd_tol(dtype, v))
            print(f"kernel 1 block_attention_fwd {dtype} causal={causal} "
                  f"(nb={nb}, na={na}, n={n}, da={da}): max_abs_err {e:.3g}")
            check(ok, f"block_attention_fwd disagrees with its plain version ({dtype}, "
                      f"causal={causal}): max abs err {e}")
            err1 = max(err1, e)
            t1[(dtype, causal)] = time_both(
                card, [lambda x=x: block_attention_fwd_cuda(*x, causal) for x in sets],
                [lambda x=x: attention_core_plain(*x, causal) for x in sets], 30)
            if dtype == "bfloat16" and not causal:
                lib1 = library_fwd_ms(sets, causal, 30)
    io = nb * na * n * da
    b1, by1 = bound_ms("bfloat16", 4 * io * 2 + na * n * n * 4, 4 * io * n)
    print(f"  kernel 1 bf16 nb={nb}: bound {b1:.4f} ms ({by1}); library call "
          f"(scaled_dot_product_attention, bias as attn_mask) {lib1:.4f} ms [{card}]")
    res["block_attention_fwd"] = dict(zip(("ms", "plain_ms"), t1[("bfloat16", False)]),
                                      err=err1, bound_ms=b1, bound_by=by1, library_ms=lib1)

    b, R = 16, 256
    err2, t2 = 0.0, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        for live in (1, 17, 255, 256):
            sets = []
            for _ in range(4 if live in (17, 256) else 1):
                kc = torch.randn((b, na, R, da), generator=g, device=dev).to(dt)
                vc = torch.randn((b, na, R, da), generator=g, device=dev).to(dt)
                kc[:, :, live:] = float("nan")  # rows >= live must never be read
                vc[:, :, live:] = float("nan")
                sets.append((kc, vc))
            kc, vc = sets[0]
            out = decode_attention_cuda(q, kc, vc, live, bias, da ** -0.5)
            ref = decode_attention_plain(q, kc, vc, live, bias, da ** -0.5)
            torch.cuda.synchronize()
            e, ok = _err(out, ref, dtype)
            print(f"kernel 2 decode_attention {dtype} live={live} "
                  f"(b={b}, na={na}, R={R}, da={da}): max_abs_err {e:.3g}")
            check(ok, f"decode_attention disagrees with its plain version ({dtype}, "
                      f"live={live}): max abs err {e}")
            err2 = max(err2, e)
            if len(sets) > 1:
                t2[(dtype, live)] = time_both(
                    card,
                    [lambda c=c: decode_attention_cuda(q, *c, live, bias, da ** -0.5) for c in sets],
                    [lambda c=c: decode_attention_plain(q, *c, live, bias, da ** -0.5) for c in sets],
                    200)
    # the library's call on the same inputs (bf16, live = 256)
    import torch.nn.functional as F

    mask = bias.to(dt)[None, :, None, :]
    lib2 = device_ms([lambda c=c: F.scaled_dot_product_attention(
        q[:, :, None], c[0], c[1], attn_mask=mask, scale=da ** -0.5) for c in sets], 200)
    b2, by2 = bound_ms("bfloat16", (2 * b * na * R * da + 2 * b * na * da) * 2 + na * R * 4,
                       4 * b * na * R * da)
    print(f"  kernel 2 bf16 b={b} live={R}: bound {b2:.4f} ms ({by2}); library call "
          f"(scaled_dot_product_attention) {lib2:.4f} ms [{card}]")
    res["decode_attention"] = dict(zip(("ms", "plain_ms"), t2[("bfloat16", 256)]), err=err2,
                                   bound_ms=b2, bound_by=by2, library_ms=lib2,
                                   sweep=decode_sweep(card))
    res["tp_shard"] = shard_kernels(card)
    return res


# the shapes of one rank's shard under TPU.MESH_MODEL 2 (phase 18's tensor
# parallel world): DSFVT's 8 heads of 128 split to 4, PR-DVQVAE2's 512 codes a
# sub-codebook split to 256
SHARD_HEADS, SHARD_CODES = 4, 256


def shard_kernels(card):
    """Kernels 1, 10, 2 and 6 at the shapes of one tensor-parallel rank's
    shard, each against its plain version on the same inputs, with times:
    kernels 1 and 10 at nb=16, 4 heads of 128, n=256; kernel 2 at b=8 (a
    rollout's rank), 4 heads, live 1 / 17 / 256 (its cluster plan at na=4);
    kernel 6 at N=8192 (a PR-DVQVAE2 b32 step), G=4, Dc=64, K=256 (its code
    split, ``nearest_plan``, at K=256). Tolerances as at the whole shapes.
    Returns {kernel: {"ms", "plain_ms", "err", "shape"}}."""
    import torch

    from lvt_tpu_torch.ops.attention import (attention_core_bwd_plain, attention_core_plain,
                                             block_attention_bwd_cuda, block_attention_fwd_cuda)
    from lvt_tpu_torch.ops.cache_attention import (decode_attention_cuda, decode_attention_plain,
                                                   decode_plan)
    from lvt_tpu_torch.ops.vq import (nearest_indices_grouped_cuda,
                                      nearest_indices_grouped_plain, nearest_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    out = {}
    nb, na, n, da = 16, SHARD_HEADS, 256, 128
    shape = f"nb={nb}, na={na}, n={n}, da={da}"
    err1 = err10 = 0.0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        sets = [[torch.randn((nb, na, n, da), generator=g, device=dev).to(dt) for _ in range(3)]
                + [0.5 * torch.randn((na, n, n), generator=g, device=dev),
                   torch.randn((nb, na, n, da), generator=g, device=dev).to(dt)]
                for _ in range(3)]
        for causal in (False, True):
            x = sets[0]
            e, ok = _err(block_attention_fwd_cuda(*x[:4], causal),
                         attention_core_plain(*x[:4], causal), dtype, fwd_tol(dtype, x[2]))
            check(ok, f"tp shard: block_attention_fwd disagrees with its plain version "
                      f"({dtype}, causal={causal}, {shape}): {e}")
            err1 = max(err1, e)
            errs = []
            for name, a, b in zip(("dq", "dk", "dv", "dbias"),
                                  block_attention_bwd_cuda(*x, causal),
                                  attention_core_bwd_plain(*x, causal)):
                e, ok = _err(a, b, dtype, DBIAS_TOL if name == "dbias" else bwd_tol(dtype, b))
                check(ok, f"tp shard: block_attention_bwd {name} disagrees with its plain "
                          f"version ({dtype}, causal={causal}, {shape}): {e}")
                errs.append(e)
            err10 = max(err10, *errs)
            print(f"tp shard, kernels 1 and 10 {dtype} causal={causal} ({shape}): max_abs_err "
                  f"fwd {err1:.3g}; dq, dk, dv, dbias {', '.join(f'{e:.3g}' for e in errs)}")
        if dtype == "bfloat16":
            fwd = [x[:4] for x in sets]
            out["block_attention_fwd"] = dict(zip(("ms", "plain_ms"), time_both(
                card, [lambda x=x: block_attention_fwd_cuda(*x, False) for x in fwd],
                [lambda x=x: attention_core_plain(*x, False) for x in fwd], 30,
                f"kernel 1 bf16 {shape} ")), shape=shape)
            out["block_attention_bwd"] = dict(zip(("ms", "plain_ms"), time_both(
                card, [lambda x=x: block_attention_bwd_cuda(*x, False) for x in sets],
                [lambda x=x: attention_core_bwd_plain(*x, False) for x in sets], 10,
                f"kernel 10 bf16 {shape} ")), shape=shape)
        del sets
    out["block_attention_fwd"]["err"], out["block_attention_bwd"]["err"] = err1, err10
    io = nb * na * n * da
    for k, nbytes, flops in (("block_attention_fwd", 4 * io * 2 + na * n * n * 4, 4 * io * n),
                             ("block_attention_bwd", 7 * io * 2 + 2 * na * n * n * 4,
                              10 * io * n)):
        out[k]["bound_ms"], out[k]["bound_by"] = bound_ms("bfloat16", nbytes, flops)

    b, R = 8, 256
    shape = f"b={b}, na={na}, R={R}, da={da}"
    err2 = 0.0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        for live in (1, 17, 256):
            sets = []
            for _ in range(4 if live == 256 else 1):
                kc = torch.randn((b, na, R, da), generator=g, device=dev).to(dt)
                vc = torch.randn((b, na, R, da), generator=g, device=dev).to(dt)
                kc[:, :, live:] = float("nan")  # rows >= live must never be read
                vc[:, :, live:] = float("nan")
                sets.append((kc, vc))
            e, ok = _err(decode_attention_cuda(q, *sets[0], live, bias, da ** -0.5),
                         decode_attention_plain(q, *sets[0], live, bias, da ** -0.5), dtype)
            check(ok, f"tp shard: decode_attention disagrees with its plain version ({dtype}, "
                      f"live={live}, {shape}): {e}")
            err2 = max(err2, e)
            print(f"tp shard, kernel 2 decode_attention {dtype} live={live} ({shape}, plan "
                  f"(cluster, chunk) {decode_plan(b, na, live)}): max_abs_err {e:.3g}")
            if dtype == "bfloat16" and live == 256:
                out["decode_attention"] = dict(zip(("ms", "plain_ms"), time_both(
                    card, [lambda c=c: decode_attention_cuda(q, *c, live, bias, da ** -0.5)
                           for c in sets],
                    [lambda c=c: decode_attention_plain(q, *c, live, bias, da ** -0.5)
                     for c in sets], 200, f"kernel 2 bf16 {shape} live={live} ")),
                    shape=shape)
    out["decode_attention"]["err"] = err2
    out["decode_attention"]["bound_ms"], out["decode_attention"]["bound_by"] = bound_ms(
        "bfloat16", (2 * b * na * R * da + 2 * b * na * da) * 2 + na * R * 4, 4 * b * na * R * da)

    N, G, K, Dc = 8192, 4, SHARD_CODES, 64
    shape = f"N={N}, G={G}, K={K}, Dc={Dc}"
    codebooks = torch.randn((G, K, Dc), generator=g, device=dev)
    n_diff = 0
    for dtype in ("float32", "bfloat16"):
        sets = [torch.randn((N, G, Dc), generator=g, device=dev).to(getattr(torch, dtype))
                for _ in range(8)]
        z = sets[0]
        got, want = nearest_indices_grouped_cuda(z, codebooks), nearest_indices_grouped_plain(
            z, codebooks)
        res = [_indices_ok(got[:, i], want[:, i], z[:, i, :], codebooks[i]) for i in range(G)]
        check(all(r[2] for r in res), f"tp shard: nearest_indices disagrees with its plain "
                                      f"version ({dtype}, {shape}): {res}")
        n_diff = max(n_diff, sum(r[0] for r in res))
        print(f"tp shard, kernel 6 nearest_indices {dtype} ({shape}, plan (ksplit, blocks) "
              f"{nearest_plan(N, G, K)}): {sum(r[0] for r in res)} of {N * G} indices differ "
              f"from the plain version's, {sum(r[1] for r in res)} of them no near-tie")
        if dtype == "bfloat16":
            out["nearest_indices"] = dict(zip(("ms", "plain_ms"), time_both(
                card, [lambda s=s: nearest_indices_grouped_cuda(s, codebooks) for s in sets],
                [lambda s=s: nearest_indices_grouped_plain(s, codebooks) for s in sets], 64,
                f"kernel 6 bf16 {shape} ")), shape=shape)
        del sets
    out["nearest_indices"]["err"] = n_diff
    out["nearest_indices"]["bound_ms"], out["nearest_indices"]["bound_by"] = bound_ms(
        "float32", N * G * Dc * 2 + G * K * Dc * 4 + N * G * 4, 2 * N * G * K * Dc)
    for k, r in out.items():
        print(f"  tp shard {k} ({r['shape']}): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")
    return out


def decode_sweep(card):
    """Kernel 2 at the rollout's batch sizes: b in (1, 8, 16) x live in (64,
    256), bf16, and fp32 at b=1 (the batch-1 rollout runs fp32); na=8,
    R=256, da=128, rows >= live poisoned with NaN. Each case against its
    plain version (TOL), device times of the kernel, the plain version and
    the library call (scaled_dot_product_attention over the live rows, the
    bias as attn_mask) over input sets of >= 64 MB together, and the bound
    from the live rows' bytes. Only the public wrappers are called, so that
    tools/ab_attention_torch.py can run this on another tree's package."""
    import torch
    import torch.nn.functional as F

    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda, decode_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    na, R, da, scale = 8, 256, 128, 128 ** -0.5
    rows = []
    for b, dtype in ((1, "float32"), (1, "bfloat16"), (8, "bfloat16"), (16, "bfloat16")):
        dt = getattr(torch, dtype)
        el = torch.finfo(dt).bits // 8
        n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da * el))))
        q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        caches = [[torch.randn((b, na, R, da), generator=g, device=dev).to(dt) for _ in range(2)]
                  for _ in range(n_sets)]
        for live in (256, 64):  # poisoning for 64 leaves nothing valid past it
            for c in caches:
                c[0][:, :, live:] = float("nan")
                c[1][:, :, live:] = float("nan")
            e, ok = _err(decode_attention_cuda(q, *caches[0], live, bias, scale),
                         decode_attention_plain(q, *caches[0], live, bias, scale), dtype)
            check(ok, f"decode_attention disagrees with its plain version ({dtype}, b={b}, "
                      f"live={live}): max abs err {e}")
            kd, pd = time_both(card, [lambda c=c: decode_attention_cuda(q, *c, live, bias, scale)
                                      for c in caches],
                               [lambda c=c: decode_attention_plain(q, *c, live, bias, scale)
                                for c in caches], 200, f"kernel 2 {dtype} b={b} live={live} ")
            mask = bias[None, :, None, :live].to(dt)
            lib = device_ms([lambda c=c: F.scaled_dot_product_attention(
                q[:, :, None], c[0][:, :, :live], c[1][:, :, :live], attn_mask=mask, scale=scale)
                for c in caches], 200)
            bd, by = bound_ms(dtype if dtype == "bfloat16" else "float32",
                              (2 * b * na * live * da + 2 * b * na * da) * el + na * live * 4,
                              4 * b * na * live * da)
            print(f"  kernel 2 sweep {dtype} b={b} live={live} [{card}]: kernel {kd:.4f} ms, "
                  f"plain {pd:.4f}, library {lib:.4f}, bound {bd:.4f} ({by}); max_abs_err {e:.3g}")
            rows.append({"dtype": dtype, "b": b, "live": live, "ms": kd, "plain_ms": pd,
                         "library_ms": lib, "bound_ms": bd, "max_abs_err": e})
        del caches
    return rows


def _counts():
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    return block_attention_fwd_cuda.launches, decode_attention_cuda.launches


def _reset_counts():
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    block_attention_fwd_cuda.launches = 0
    decode_attention_cuda.launches = 0


def _captures():
    """(slice graphs captured, their seconds: warm-up, capture and
    instantiation) so far in this process; (0, 0.0) on a tree without the
    graph (tools/ab_attention_torch.py runs phases on a parent tree)."""
    try:
        from lvt_tpu_torch.models.rollout_graph import SliceGraph
    except ImportError:
        return 0, 0.0
    return SliceGraph.captures, SliceGraph.captures_seconds


def _rollout_line(seconds, before, b, n_slices, peak):
    """The rollout's seconds, the captures' share of them, frames/s with and
    without that share, and the peak memory."""
    n, cap = (x - y for x, y in zip(_captures(), before))
    return (f"rollout {seconds:.3f} s, of it {cap:.3f} s capturing {n} graph(s) (warm-up "
            f"included); {b * n_slices / seconds:.3f} generated frames/s, "
            f"{b * n_slices / (seconds - cap):.3f} without the capture; max_memory_allocated "
            f"{peak / 2 ** 20:.1f} MiB")


def _check_run(label, video, codes, primed, nv, b):
    import torch

    check(tuple(video.shape) == (b, T_FRAMES, 64, 64, 3), f"{label}: video shape {video.shape}")
    check(bool(torch.isfinite(video).all()), f"{label}: non-finite frames")
    check(float(video.min()) >= 0.0 and float(video.max()) <= 255.0,
          f"{label}: frames outside [0, 255]")
    check(bool((codes[:, :, :N_PRIME] == primed).all()), f"{label}: primed codes changed")
    check(int(codes.min()) >= 0 and int(codes.max()) < nv, f"{label}: codes outside [0, {nv})")


def phase_main(card):
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    cfg_file = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    example = os.path.join(ROOT, "example")
    out_dir = os.path.join(ROOT, "output", "chip_smoke")
    n_slices = T_FRAMES - N_PRIME
    per_run = (n_slices * 8, n_slices * 256 * 8)  # encoder layers, pixels x decoder layers

    _reset_counts()  # the counts cover phase 4 only
    before = _captures()
    torch.cuda.reset_peak_memory_stats()
    video, codes, primed, seconds = gvt.main(
        ["--config-file", cfg_file, "--video-dir", example, "--seed", "0",
         "OUTPUT_DIR", out_dir] + NO_VQ_WEIGHTS)
    launches = _counts()
    line = _rollout_line(seconds, before, 1, n_slices, torch.cuda.max_memory_allocated())
    _check_run("batch 1", video, codes, primed, 512, 1)
    check(launches == per_run, f"batch 1: kernel launches {launches}, want exactly {per_run}")
    print(f"main path batch 1 fp32 [{card}]: {line}; launches {launches}")

    cfg = gvt.load_config(cfg_file)
    dev = torch.device("cuda")
    models = gvt.build_models(cfg, 0, dev, torch.bfloat16)
    frames = torch.from_numpy(gvt.load_priming_frames(example, N_PRIME)).to(dev)
    b = 8
    gen = torch.Generator(device=dev).manual_seed(0)
    before, caps = _counts(), _captures()
    torch.cuda.reset_peak_memory_stats()
    video, codes, primed, seconds = gvt.generate(
        *models, frames[None].expand(b, *frames.shape).contiguous(), N_PRIME, gen)
    total = _counts()
    launches = (total[0] - before[0], total[1] - before[1])
    line = _rollout_line(seconds, caps, b, n_slices, torch.cuda.max_memory_allocated())
    _check_run("batch 8", video, codes, primed, 512, b)
    check(launches == per_run, f"batch 8: kernel launches {launches}, want exactly {per_run}")
    print(f"main path batch 8 bf16 [{card}]: {line}; launches {launches}")
    return total, models, codes


SLICE_MODES = (  # label, knobs of sample_slice_incremental: every sampler mode alone
    ("native", {}),
    ("int8 KV + xla", {"kv_dtype": "int8"}),
    ("int8 KV + xla + int8 mm", {"kv_dtype": "int8", "mm_dtype": "int8"}),
    ("int8 KV + pallas", {"kv_dtype": "int8", "attn_impl": "pallas"}),
    ("int8 KV + pallas-live", {"kv_dtype": "int8", "attn_impl": "pallas-live"}),
    ("int8 weights", {"weight_dtype": "int8"}),
    ("int8-pallas weights", {"weight_dtype": "int8-pallas"}))
# (int8 KV + pallas with int8-pallas weights, kernels 3 and 11 together, runs as
# a whole rollout in phase 11 and in phase 20's DSSVT; each of its kernels'
# modes stands above, so phases 11b and 12 leave the pair out for the time
# limit)
# Phase 11b profiles the native slice and the modes that phase 11 does not roll
# out (for the time limit); phase 11 holds the last slice of each of its
# rollouts to the eager loop, so every mode's graph is held to it.
SLICE_PROFILED = tuple(m for m in SLICE_MODES if m[0] in (
    "native", "int8 KV + xla + int8 mm", "int8 weights", "int8-pallas weights"))
# device activities of a slice under the graph against the eager loop's: the
# same launches, plus the copies of the slice's inputs into the graph's
# buffers and of its codes out (4 a slice), within a share of the eager
# count. torch.profiler drops records of a profile this long now and then:
# the same eager slice has read 185,769 activities in one call and 185,828 in
# another, in one call both eager profiles of a slice lacked 6 or 7 launches
# each of several of PyTorch's kernels that its graph, replaying the same
# launches, showed, and in another the two eager profiles of a slice read
# 87,386 and 91,414 of its ~91,620. A profile may drop records, never add
# one. So each function's launches are the most any profile of its way
# recorded; each way is profiled PROFILES times, on until a profile records
# within PROFILES_AGREE of those maxima; and while the slice's checks
# (activities within ACTIVITY_GAP, the hand-written kernels' launches exact)
# do not hold on the maxima, each way is profiled once more, PROFILES_MAX
# times at the most: a profile is followed by the next only where the records
# it dropped fail those checks.
ACTIVITY_GAP = 1e-3
PROFILES = 1
PROFILES_MAX = 4
PROFILES_AGREE = ACTIVITY_GAP / 4


class _Profiles:
    """fn() run once unprofiled (``wall``; with ``unprofiled=False`` not, and
    ``wall`` None), then under torch.profiler once a call of ``add``, each
    run synchronized: ``counts`` {device function: the most launches any
    profile recorded}, ``totals`` the profiles' activity counts, ``best``
    (wall s under the profiler, device events as (name, µs)) of the profile
    with the most events; ``out`` fn's result of its first run. The events
    are the profiler's raw records: turning ~100k of them into FunctionEvents
    took ~15 s a profile."""

    def __init__(self, fn, unprofiled=True):
        import torch

        self.fn, self.out, self.wall = fn, None, None
        if unprofiled:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.out = fn()
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - t0
        self.best, self.counts, self.totals = None, {}, []

    def add(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = self.fn()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        if self.out is None:
            self.out = out
        kern = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA]
        if self.best is None or len(kern) > len(self.best[1]):
            self.best = (wall_prof, kern)
        for name, (_, cnt) in _by_name(kern).items():
            self.counts[name] = max(self.counts.get(name, 0), cnt)
        self.totals.append(len(kern))

    def settled(self):
        """The last profile lies within PROFILES_AGREE of the maxima."""
        full = sum(self.counts.values())
        return full - self.totals[-1] <= PROFILES_AGREE * full

    def fill(self, least, most):
        """Profile at least ``least`` times, and on until settled, ``most``
        times at the most."""
        while len(self.totals) < most and (len(self.totals) < least or not self.settled()):
            self.add()
        return self

    def result(self):
        return (self.out, self.wall) + self.best + (self.counts, self.totals)


def _profiled(fn, profiles=1, most=1):
    """(result, wall s, wall s under torch.profiler, device events as (name,
    µs) of the profile with the most of them, {device function: launches},
    totals of the profiles) of fn(), run once unprofiled and then profiled
    ``profiles`` times, and on while the last profile records fewer
    activities than the most each function showed in the profiles so far by
    more than a share PROFILES_AGREE of them, ``most`` times at the most
    (``_Profiles``)."""
    return _Profiles(fn).fill(profiles, most).result()


def _by_name(kern):
    by_name = {}
    for name, us in kern:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us / 1e3, cnt + 1)
    return by_name


# the hand-written kernels of the rollout: (label, the device functions' names
# by a part of them, the wrappers that launch them)
HAND_WRITTEN = (
    ("kernel 1", ("block_attention_",), ("block_attention_fwd_cuda",)),
    ("kernel 2", ("decode_attention_kernel",), ("decode_attention_cuda",)),
    ("kernel 3", ("decode_i8_kernel<128, 4, false", "decode_i8_kernel<128, 8, false",
                  "decode_attention_i8_kernel"),
     ("decode_attention_i8_cuda", "decode_attention_i8_step_cuda")),
    ("kernel 4", ("decode_i8_kernel<128, 4, true", "decode_i8_kernel<128, 8, true",
                  "decode_attention_i8_live_kernel"),
     ("decode_attention_i8_live_cuda", "decode_attention_i8_live_step_cuda")),
    ("kernel 11", ("matmul_i8w_kernel",), ("matmul_i8w_cuda",)))


def _label(name):
    """The hand-written kernel a device function belongs to (the first whose
    key its name holds), or None."""
    return next((lb for lb, ks, _ in HAND_WRITTEN if any(k in name for k in ks)), None)


def _hand_sums(by_name):
    """{label: (device ms, launches)} of the hand-written kernels, each summed
    over its templates."""
    sums = {}
    for name, (tot, cnt) in by_name.items():
        label = _label(name)
        if label is not None:
            t0, c0 = sums.get(label, (0.0, 0))
            sums[label] = (t0 + tot, c0 + cnt)
    return sums


def _hand_counts(counts):
    """{label: launches} of the hand-written kernels from {device function:
    launches}."""
    out = {}
    for name, cnt in counts.items():
        label = _label(name)
        if label is not None:
            out[label] = out.get(label, 0) + cnt
    return out


def _hand_written(by_name):
    return ", ".join(f"{label} {t:.2f} ms ({cnt}x, {t / cnt:.4f} ms each)"
                     for label, (t, cnt) in _hand_sums(by_name).items())


def _hand_launches(took):
    """{label: launches} of the hand-written kernels from {wrapper: launches}
    (``SliceGraph.launches``, ``rollout_graph.launches_apart``)."""
    out = {}
    for label, _, wrappers in HAND_WRITTEN:
        n = sum(cnt for fn, cnt in took.items() if fn.__name__ in wrappers)
        if n:
            out[label] = n
    return out


def phase_slices(card, models, codes, modes=SLICE_MODES, vts=None):
    """One slice (256 pixels) of the batch-8 bf16 rollout, greedy, in every
    sampler mode, through the eager loop and through the slice's CUDA graph
    (captured first, outside the timings, unless ``vts``, phase 11's model of
    the mode by label, holds it already): the codes bit-equal; wall time,
    device busy share, device activities per pixel (copies and casts among
    them) of each, under torch.profiler, each device function's launches the
    most that any of its profiles recorded (see PROFILES); the graph's
    activities per pixel within a share ACTIVITY_GAP of the eager loop's, and
    each hand-written kernel's launches in the graph's profiles exactly those
    the capture recorded (kernel 1: the encoder's); device time by kernel and
    of the hand-written kernels in the graph's slice. Each run includes the slice's
    encoder pass (kernel 1), as the rollout runs it."""
    import numpy as np
    import torch

    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    *_, vt, params = models
    c, plan, s = vt.c, vt.plan, N_PRIME
    b = codes.shape[0]
    on_graph = hasattr(vt, "_slice_graph")  # False on a tree before the graph (A/B tool)
    if on_graph:
        from lvt_tpu_torch.models.rollout_graph import launches_apart
    thw = plan.slice_src[s].size
    primed = np.zeros(thw, bool)
    primed_t = torch.zeros(thw, dtype=torch.bool, device=codes.device)
    taken = {}  # {mode: {way: profiles}}

    def encoded():
        sidx = torch.full((b,), s, dtype=torch.int64, device=codes.device)
        ctx, sl, _ = vt.prepare_slices(codes, sidx)
        return vt_encode(params["netG"], c, ctx, sidx), sl

    for label, knobs in modes:
        knobs = {"kv_dtype": "native", "weight_dtype": "native", "mm_dtype": "native",
                 "attn_impl": "xla", **knobs}
        with torch.no_grad():
            if on_graph:  # the set-up made once, as sample_video makes it
                from lvt_tpu_torch.models.vt_incremental import SliceDecoder

                dec = SliceDecoder(params["netG"], c, plan.slice_shape, b, codes.device, **knobs)

            def eager():
                zl, sl = encoded()
                if on_graph:
                    return dec.run(zl, sl, primed_t, None, 1.0, True)
                return sample_slice_incremental(params["netG"], c, plan.slice_shape, zl, sl,
                                                None, primed, 1.0, greedy=True, **knobs)
            # the eager way profiled only (its unprofiled run, 1.3-3.7 s a mode,
            # left out for the time limit; phase 11 times the eager loop)
            ways = {"eager": _Profiles(eager, unprofiled=False).fill(PROFILES, PROFILES_MAX)}
            if on_graph:
                zl, sl = encoded()
                graph = (vts or {}).get(label, vt)._slice_graph(params, zl, sl, primed_t, knobs,
                                                                 1.0, True)

                def replay():
                    zl, sl = encoded()
                    return graph(zl, sl, primed_t)
                ways["graph"] = _Profiles(replay).fill(1, PROFILES_MAX)
                # the launches a replay must show: the capture's, and the
                # encoder's (kernel 1, eager, outside the graph)
                with launches_apart() as took:
                    encoded()
                want_hand = _hand_launches(took)
                for kernel, n in _hand_launches(graph.launches).items():
                    want_hand[kernel] = want_hand.get(kernel, 0) + n

                def holds():  # the slice's checks below, on the maxima so far
                    e, g = (sum(ways[w].counts.values()) for w in ("eager", "graph"))
                    return (abs(g - e) <= ACTIVITY_GAP * e
                            and _hand_counts(ways["graph"].counts) == want_hand)
                while not holds() and any(len(w.totals) < PROFILES_MAX for w in ways.values()):
                    for w in ways.values():
                        if len(w.totals) < PROFILES_MAX:
                            w.add()
            runs = {way: w.result() for way, w in ways.items()}
        taken[label] = {way: len(run[-1]) for way, run in runs.items()}
        acts = {}
        for way, (out, wall, wall_prof, kern, counts, totals) in runs.items():
            busy = sum(us for _, us in kern) / 1e6
            by_name = _by_name(kern)
            copies = sum(cnt for name, cnt in counts.items()
                         if "copy" in name.lower() or "memcpy" in name.lower())
            n = sum(counts.values())
            acts[way] = n / thw
            print(f"profile, one slice (256 pixels) of the batch-{b} bf16 rollout, {label}, "
                  f"{way} [{card}]: wall "
                  + (f"{wall:.3f} s ({wall_prof:.3f} s under the profiler)" if wall is not None
                     else f"{wall_prof:.3f} s under the profiler")
                  + f", device busy {busy:.3f} s = {100 * busy / wall_prof:.1f}% of the profiled "
                  f"wall time"
                  + (f", {100 * busy / wall:.1f}% of the unprofiled" if wall is not None else "")
                  + f"; {n} device "
                  f"activities = {n / thw:.2f} per pixel (each function's most in "
                  f"{len(totals)} profiles of {', '.join(map(str, totals))}), copies and casts "
                  f"{copies / thw:.2f} per pixel"
                  + (f"; captured in {graph.capture_seconds:.3f} s (warm-up "
                     f"{graph.warmup_seconds:.3f} s)" if way == "graph" else ""))
            if way == "graph" or not on_graph:
                for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
                    print(f"  {tot:9.2f} ms {cnt:7d}x  {name[:110]}")
                print(f"  hand-written kernels in the slice: {_hand_written(by_name)}")
        if knobs["kv_dtype"] == "int8" and knobs["attn_impl"] != "xla":
            # kernel 3 or 4 once per layer and pixel, live = p + 1
            na, _, da = params["netG"]["decoder"]["layers"][0]["wq"].shape
            layers = len(params["netG"]["decoder"]["layers"])
            bound = layers * sum(i8_bound_ms(b, na, live, da)[0] for live in range(1, thw + 1))
            print(f"  bound of kernel 3 or 4 over the slice's {layers * thw} calls "
                  f"(live 1 to {thw}): {bound:.2f} ms")
        if on_graph:
            check(torch.equal(runs["graph"][0], runs["eager"][0]),
                  f"{label}: the graph's greedy codes differ from the eager loop's")
            counts = {way: run[4] for way, run in runs.items()}
            differ = {name: (counts["eager"].get(name, 0), counts["graph"].get(name, 0))
                      for name in set(counts["eager"]) | set(counts["graph"])
                      if counts["eager"].get(name, 0) != counts["graph"].get(name, 0)}
            check(abs(acts["graph"] - acts["eager"]) <= ACTIVITY_GAP * acts["eager"],
                  f"{label}: device activities per pixel {acts['graph']:.3f} under the graph, "
                  f"{acts['eager']:.3f} eager; want within {ACTIVITY_GAP:g} of the eager count; "
                  f"counts (eager, graph) that differ: {differ}")
            seen = _hand_counts(counts["graph"])
            check(seen == want_hand,
                  f"{label}: hand-written kernels' launches in the graph's profile {seen}, want "
                  f"exactly the capture's and the encoder's {want_hand}")
            print(f"  hand-written kernels' launches in the graph's profile: {seen}, the "
                  "capture's and the encoder's exactly")
    if on_graph:
        print(f"slices [{card}]: greedy codes of the graph equal the eager loop's in all "
              f"{len(modes)} modes (b = {b}, bf16, full width); profiles each way took "
              f"(least {PROFILES}, most {PROFILES_MAX}): {json.dumps(taken)}")


def phase_agree(card):
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import vt_encode, vt_logits
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    dev = torch.device("cuda")
    *_, vt, params = gvt.build_models(cfg, 1, dev, torch.float32)
    netg = params["netG"]
    netg_cpu = to_device(netg, "cpu")
    c, plan = vt.c, vt.plan
    video = np.random.default_rng(0).integers(0, c.nv, size=(2, c.nc, T_FRAMES, 16, 16))
    s = N_PRIME
    out = {}
    for name, device, p in (("card", dev, netg), ("cpu", torch.device("cpu"), netg_cpu)):
        sidx = torch.full((2,), s, dtype=torch.int64, device=device)
        ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video).to(device), sidx)
        with torch.no_grad():
            out[name] = vt_logits(p, c, ctx, sl, sidx).reshape(2, -1, c.nc, c.nv).cpu()
            if name == "card":
                zl = vt_encode(p, c, ctx, sidx)
                _, out["teacher"] = sample_slice_incremental(
                    p, c, plan.slice_shape, zl, sl, None, np.ones(256, bool), 1.0,
                    teacher_logits=True)
                out["teacher"] = out["teacher"].cpu()
                # control: the same logits with TF32 GEMMs and convolutions
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    out["tf32"] = vt_logits(p, c, ctx, sl, sidx).reshape(2, -1, c.nc, c.nv).cpu()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
    e_logits, e_teacher, e_tf32 = (float((out[k] - out["cpu"]).abs().max())
                                   for k in ("card", "teacher", "tf32"))
    scale = float(out["cpu"].abs().max())
    print(f"agree fp32 b=2 full width: vt_logits card vs cpu plain max_abs_err {e_logits:.3g}, "
          f"incremental teacher logits (card) vs cpu plain {e_teacher:.3g}; control with TF32 "
          f"on {e_tf32:.3g}; bound {PATH_TOL:g} (|logits| <= {scale:.3g})")
    check(e_logits <= PATH_TOL, f"vt_logits on the card disagrees with the plain path: {e_logits}")
    check(e_teacher <= PATH_TOL,
          f"incremental teacher logits disagree with the plain path: {e_teacher}")
    check(e_tf32 > PATH_TOL, f"the TF32 control reads {e_tf32}, within the bound {PATH_TOL}: "
                             "the bound cannot tell a TF32 path from a true-fp32 one")


def _reference_vt_state(rng, c):
    """A VideoTransformer state dict in the reference key layout
    (videotransformer.py's module paths, as checkpoint/torch_convert.py reads
    them) for the port's VTConfig ``c``, from a numpy generator: weights
    N(0, 1 / fan-in), embeddings N(0, 1), norms near 1, biases and bias
    banks near 0."""
    import numpy as np

    def w(*shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)).astype(np.float32)

    def small(*shape):
        return (0.01 * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)

    kt, kh, kw = c.kernel
    sd = {"encoder.conv.weight": w(c.de, c.nc * c.nv, kt, kh, kw, fan_in=c.nc * kt * kh * kw),
          "encoder.conv.bias": small(c.de),
          "encoder.slice_embedding.weight": rng.standard_normal(
              (c.stride[0] * c.stride[1] * c.stride[2], c.de), dtype=np.float32),
          "encoder.linear_projector.weight": w(c.d, c.de, 1, 1, 1, fan_in=c.de)}
    for pfx, blocks, heads in (("encoder", c.blocks_e, c.n_head_e),
                               ("decoder", c.blocks_d, c.n_head_d)):
        for i, ((t, h, bw), na) in enumerate(zip(blocks, heads)):
            p = f"{pfx}.block_local_attention.{i}"
            sd[f"{p}.mha.layer_norm.weight"], sd[f"{p}.mha.layer_norm.bias"] = \
                1 + small(c.d), small(c.d)
            for m in ("w_q", "w_k", "w_v"):
                sd[f"{p}.mha.{m}"] = w(na, c.d, c.da, fan_in=c.d)
            sd[f"{p}.mha.proj.weight"] = w(c.d, na * c.da, fan_in=na * c.da)
            sd[f"{p}.ffn.0.weight"], sd[f"{p}.ffn.0.bias"] = 1 + small(c.d), small(c.d)
            for j in (1, 3):
                sd[f"{p}.ffn.{j}.weight"], sd[f"{p}.ffn.{j}.bias"] = \
                    w(c.d, c.d, fan_in=c.d), small(c.d)
            for axis, n in (("dt", t), ("dh", h), ("dw", bw)):
                sd[f"{p}.{axis}_bank"] = small(na, 2 * n - 1)
    for k in range(c.nc):
        sd[f"decoder.ch_embedder.{k}.weight"] = rng.standard_normal((c.nv, c.de),
                                                                    dtype=np.float32)
    sd["decoder.conv.conv.weight"] = w(c.d, c.de, 3, 3, 3, fan_in=27 * c.de)
    sd["decoder.conv.conv.bias"] = small(c.d)
    sd["decoder.linear_projector.weight"] = w(c.d, c.d, 1, 1, 1, fan_in=c.d)
    sd["ch_predictor.layer_norm.weight"] = 1 + small(c.d)
    sd["ch_predictor.layer_norm.bias"] = small(c.d)
    for k in range(c.nc):
        sd[f"ch_predictor.U.{k}.weight"] = w(c.d, c.d + k * c.nv, fan_in=c.d + k)
        sd[f"ch_predictor.U.{k}.bias"] = small(c.d)
        sd[f"ch_predictor.P.{k}.weight"] = w(c.nv, c.d, fan_in=c.d)
        sd[f"ch_predictor.P.{k}.bias"] = small(c.nv)
    return sd


def _reference_seqnet_state(rng, spec):
    """A norm-free conv net's state dict in module order (the reference's
    Sequential): ``layers.<i>.{weight,bias}`` for a conv (out, in, k, k) or
    transposed conv (in, out, k, k), ``layers.<i>.block.{1,3}.*`` for a
    residual block (ReLU, conv 3x3, ReLU, conv 1x1); N(0, 1 / fan-in)."""
    import numpy as np

    def w(*shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)).astype(np.float32)

    sd = {}
    for i, layer in enumerate(spec):
        key = f"layers.{i}"
        if layer[0] in ("conv", "convT"):
            _, cin, cout, k = layer[:4]
            shape = (cout, cin, k, k) if layer[0] == "conv" else (cin, cout, k, k)
            sd[f"{key}.weight"], sd[f"{key}.bias"] = w(*shape, fan_in=cin * k * k), \
                np.zeros(cout, np.float32)
        elif layer[0] == "resblock":
            _, dim, res = layer
            sd[f"{key}.block.1.weight"] = w(res, dim, 3, 3, fan_in=9 * dim)
            sd[f"{key}.block.1.bias"] = np.zeros(res, np.float32)
            sd[f"{key}.block.3.weight"] = w(dim, res, 1, 1, fan_in=res)
            sd[f"{key}.block.3.bias"] = np.zeros(dim, np.float32)
    return sd


def phase_pth(card):
    """Generation from reference .pth files at full width: DSFVT's and
    PR-DVQVAE2's netE, netG and netC state dicts in the reference key layout,
    written from a numpy seed as fvcore's Checkpointer wraps them; the
    generation script as a user runs it with the four files configured;
    then one slice's fp32 logits of the VT loaded on the card against the
    same file loaded on the CPU. Returns the phase's seconds."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.evaluation.vt_sampler import load_vt_weights
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.models.vt import VTConfig, vt_logits

    t0 = time.perf_counter()
    cfg_file = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    cfg = gvt.load_config(cfg_file)
    c = VTConfig.from_cfg(cfg)
    vq = VQVAE(gvt.load_config(os.path.join(ROOT, cfg.TEST.VT_SAMPLER.VQ_VAE.CFG)))
    rng = np.random.default_rng(PTH_SEED)
    cb = vq.cfg.MODEL.CODEBOOK
    dc = cb.DIM // cb.NUM
    states = {"netE": _reference_seqnet_state(rng, vq.encoder.spec),
              "netG": _reference_seqnet_state(rng, vq.generator.spec),
              "netC": {k: v for i in range(cb.NUM) for k, v in (
                  (f"ve.{i}.embedding.weight",
                   rng.standard_normal((cb.SIZE, dc), dtype=np.float32)),
                  (f"ve.{i}.running_size", np.ones(cb.SIZE, np.float32)),
                  (f"ve.{i}.running_sum", rng.standard_normal((cb.SIZE, dc), dtype=np.float32)))},
              "vt": _reference_vt_state(rng, c)}
    n_slices = T_FRAMES - N_PRIME
    per_run = (n_slices * 8, n_slices * 256 * 8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, sd in states.items():
            os.makedirs(os.path.join(tmp, name))
            paths[name] = os.path.join(tmp, name, "model_final.pth")
            torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                        "iteration": 0}, paths[name])
        del states
        opts = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", paths["netE"],
                "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", paths["netG"],
                "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", paths["netC"],
                "MODEL.GENERATOR.WEIGHTS", paths["vt"]]
        written = time.perf_counter() - t0
        _reset_counts()
        before = _captures()
        torch.cuda.reset_peak_memory_stats()
        video, codes, primed, seconds = gvt.main(
            ["--config-file", cfg_file, "--video-dir", os.path.join(ROOT, "example"), "--seed",
             "0", "OUTPUT_DIR", os.path.join(ROOT, "output", "chip_smoke_pth")] + opts)
        launches = _counts()
        line = _rollout_line(seconds, before, 1, n_slices, torch.cuda.max_memory_allocated())
        _check_run("pth batch 1", video, codes, primed, c.nv, 1)
        check(launches == per_run, f"pth batch 1: kernel launches {launches}, want {per_run}")
        print(f"pth main path batch 1 fp32, reference .pth weights [{card}]: {line}; launches "
              f"{launches}; files written in {written:.1f} s")

        # the VT read from the same file on the card and on the CPU: the same
        # leaves, and one slice's teacher-forced fp32 logits within PATH_TOL
        cfgp = gvt.load_config(cfg_file, opts)
        video = np.random.default_rng(1).integers(0, c.nv, size=(2, c.nc, T_FRAMES, 16, 16))
        out, trees = {}, {}
        for device in (torch.device("cuda"), torch.device("cpu")):
            vt, init = gvt.build_vt(cfgp, torch.Generator().manual_seed(0), device, 16, 16)
            params = load_vt_weights(cfgp, init)["netG"]
            trees[device.type] = flatten(params)
            sidx = torch.full((2,), N_PRIME, dtype=torch.int64, device=device)
            ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video).to(device), sidx)
            with torch.no_grad():
                out[device.type] = vt_logits(params, c, ctx, sl, sidx).reshape(
                    2, -1, c.nc, c.nv).cpu()
    same = all(torch.equal(trees["cuda"][k].cpu(), v) for k, v in trees["cpu"].items())
    check(same and trees["cuda"].keys() == trees["cpu"].keys(),
          "pth: the VT's leaves loaded on the card differ from those loaded on the CPU")
    e = float((out["cuda"] - out["cpu"]).abs().max())
    took = time.perf_counter() - t0
    print(f"pth agree fp32 b=2 full width: vt_logits card vs cpu plain on the same .pth "
          f"max_abs_err {e:.3g}; bound {PATH_TOL:g} (|logits| <= "
          f"{float(out['cpu'].abs().max()):.3g}); phase {took:.1f} s [{card}]")
    check(e <= PATH_TOL, f"pth: vt_logits on the card disagree with the plain path: {e}")
    return took


def phase_train_kernels(card):
    """Kernels 10 and 1 at the training path's shapes (nb=64), each against
    its plain version on the same input sets."""
    import torch

    from lvt_tpu_torch.ops.attention import (attention_core_bwd_plain, attention_core_plain,
                                             block_attention_bwd_cuda, block_attention_fwd_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    nb, na, n, da = 64, 8, 256, 128
    shape = f"nb={nb}, na={na}, n={n}, da={da}"
    err, times, err1, times1 = 0.0, {}, 0.0, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        sets = [[torch.randn((nb, na, n, da), generator=g, device=dev).to(dt) for _ in range(3)]
                + [0.5 * torch.randn((na, n, n), generator=g, device=dev),
                   torch.randn((nb, na, n, da), generator=g, device=dev).to(dt)]
                for _ in range(3)]
        for causal in (False, True):
            got = block_attention_bwd_cuda(*sets[0], causal)
            again = block_attention_bwd_cuda(*sets[0], causal)
            want = attention_core_bwd_plain(*sets[0], causal)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
                e, ok = _err(a, b, dtype, DBIAS_TOL if name == "dbias" else bwd_tol(dtype, b))
                check(ok, f"block_attention_bwd {name} disagrees with its plain version "
                          f"({dtype}, causal={causal}): max abs err {e}")
                errs.append(e)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"block_attention_bwd ({dtype}, causal={causal}): two calls differ")
            print(f"kernel 10 block_attention_bwd {dtype} causal={causal} ({shape}): "
                  f"max_abs_err dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}, dbias "
                  f"{errs[3]:.3g} (|dbias| <= {float(want[3].abs().max()):.3g}); two calls "
                  "bit-identical")
            err = max(err, *errs)
            del got, again, want
            times[(dtype, causal)] = time_both(
                card, [lambda x=x: block_attention_bwd_cuda(*x, causal) for x in sets],
                [lambda x=x: attention_core_bwd_plain(*x, causal) for x in sets], 10)
            if dtype == "bfloat16" and not causal:
                lib10 = library_bwd_ms(sets, causal, 10)
                lib1 = library_fwd_ms(sets, causal, 10)

            fwd = [x[:4] for x in sets]  # q, k, v, bias
            out = block_attention_fwd_cuda(*fwd[0], causal)
            ref = attention_core_plain(*fwd[0], causal)
            torch.cuda.synchronize()
            e, ok = _err(out, ref, dtype, fwd_tol(dtype, fwd[0][2]))
            print(f"kernel 1 block_attention_fwd {dtype} causal={causal} ({shape}): "
                  f"max_abs_err {e:.3g}")
            check(ok, f"block_attention_fwd disagrees with its plain version at the training "
                      f"shape ({dtype}, causal={causal}): max abs err {e}")
            err1 = max(err1, e)
            del out, ref
            times1[(dtype, causal)] = time_both(
                card, [lambda x=x: block_attention_fwd_cuda(*x, causal) for x in fwd],
                [lambda x=x: attention_core_plain(*x, causal) for x in fwd], 10)
    io = nb * na * n * da
    b10, by10 = bound_ms("bfloat16", 7 * io * 2 + 2 * na * n * n * 4, 10 * io * n)
    b1, by1 = bound_ms("bfloat16", 4 * io * 2 + na * n * n * 4, 4 * io * n)
    print(f"  bf16 nb={nb}: kernel 10 bound {b10:.4f} ms ({by10}), library call (autograd "
          f"backward of scaled_dot_product_attention, events) {lib10:.4f} ms; kernel 1 bound "
          f"{b1:.4f} ms ({by1}), library call {lib1:.4f} ms [{card}]")
    k10 = dict(zip(("ms", "plain_ms"), times[("bfloat16", False)]), err=err, bound_ms=b10,
               bound_by=by10, library_ms=lib10)
    return k10, err1, times1


def phase_attention_shapes(card):
    """Kernels 1 and 10 in bf16 at the widths the DSFVT shapes leave out: n
    in (48, 200, 256) x da in (64, 128) x causal, nb = 3; kernel 10's dbias
    planes at nb in (1, 3, 64) (runs of one block, and of eight); two calls
    of kernel 1 bit-identical. Tolerances as phases 3 and 6."""
    import torch

    from lvt_tpu_torch.ops.attention import (attention_core_bwd_plain, attention_core_plain,
                                             block_attention_bwd_cuda, block_attention_fwd_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    worst = {"fwd": 0.0, "bwd": 0.0, "dbias": 0.0}
    cases = [(3, n, da) for n in (48, 200, 256) for da in (64, 128)] + \
        [(nb, 256, 128) for nb in (1, 64)]
    for nb, n, da in cases:
        for causal in (False, True):
            q, k, v, go = (torch.randn((nb, 8, n, da), generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            bias = 0.5 * torch.randn((8, n, n), generator=g, device=dev)
            out = block_attention_fwd_cuda(q, k, v, bias, causal)
            again = block_attention_fwd_cuda(q, k, v, bias, causal)
            e, ok = _err(out, attention_core_plain(q, k, v, bias, causal), "bfloat16",
                         fwd_tol("bfloat16", v))
            what = f"(bf16, nb={nb}, n={n}, da={da}, causal={causal})"
            check(ok, f"block_attention_fwd disagrees with its plain version {what}: {e}")
            check(torch.equal(out, again), f"block_attention_fwd {what}: two calls differ")
            worst["fwd"] = max(worst["fwd"], e)
            got = block_attention_bwd_cuda(q, k, v, bias, go, causal)
            want = attention_core_bwd_plain(q, k, v, bias, go, causal)
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
                e, ok = _err(a, b, "bfloat16",
                             DBIAS_TOL if name == "dbias" else bwd_tol("bfloat16", b))
                check(ok, f"block_attention_bwd {name} disagrees with its plain version "
                          f"{what}: {e}")
                key = "dbias" if name == "dbias" else "bwd"
                worst[key] = max(worst[key], e)
            del out, again, got, want
    torch.cuda.synchronize()
    print(f"kernels 1 and 10 bf16 at n in (48, 200, 256) x da in (64, 128) x causal (nb=3), "
          f"and nb in (1, 64) at n=256, da=128: max_abs_err fwd {worst['fwd']:.3g}, "
          f"dq/dk/dv {worst['bwd']:.3g}, dbias {worst['dbias']:.3g}; kernel 1 two calls "
          f"bit-identical [{card}]")
    return worst


def phase_fused_kernels(card):
    """Kernels 7, 8 and 9 at the DSFVT training shape, each against its plain
    version on the same inputs; two calls bit-identical; device times beside
    the plain versions' and the unfused layer's."""
    import torch

    from lvt_tpu_torch.models.vt import init_block_attn
    from lvt_tpu_torch.ops import fused_layer as fl
    from lvt_tpu_torch.ops.attention import ffn_tokens, mha_tokens, relative_bias

    dev = torch.device("cuda")
    nb, block, na, d, da = 64, (1, 16, 16), 8, 512, 128
    n, rows = 256, 64 * 256
    shape = f"nb={nb}, n={n}, d={d}, na={na}, da={da}"
    gen = torch.Generator().manual_seed(7)
    p32 = init_block_attn(gen, block, na, d, da)
    for key in ("dt_bank", "dh_bank", "dw_bank", "ln_bias", "ffn_ln_bias", "ffn_b1", "ffn_b2"):
        p32[key] = 0.1 * torch.randn(p32[key].shape, generator=gen)
    res = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        p = {k: v.to(dev, dt) for k, v in p32.items()}
        bias = relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], block).float().contiguous()
        g = torch.Generator(device=dev).manual_seed(8)
        sets = [[torch.randn((nb, n, d), generator=g, device=dev).to(dt) for _ in range(2)]
                for _ in range(3)]  # (tok, cotangent) x 3: 100 MB in bf16, over the L2
        errs = {7: 0.0, 8: 0.0, 9: 0.0}
        for causal in (False, True):
            tok, go = sets[0]
            # kernel 7, with and without x2
            out, x2 = fl.fused_layer_fwd_cuda(tok, p, bias, causal, True)
            alone = fl.fused_layer_fwd_cuda(tok, p, bias, causal)
            again = fl.fused_layer_fwd_cuda(tok, p, bias, causal, True)
            w_out, w_x2 = fl.fused_layer_tokens_plain(tok, p, bias, causal, True)
            torch.cuda.synchronize()
            e7 = []
            for name, a, b in (("out", out, w_out), ("x2", x2, w_x2), ("out alone", alone, w_out)):
                e, ok = _err(a, b, dtype, fused_tol(dtype, b))
                check(ok, f"fused_layer_fwd {name} disagrees with its plain version ({dtype}, "
                          f"causal={causal}): max abs err {e}")
                e7.append(e)
            check(torch.equal(out, again[0]) and torch.equal(x2, again[1]),
                  f"fused_layer_fwd ({dtype}, causal={causal}): two calls differ")
            # kernel 8 from the plain version's x2, kernel 9 from its dx2
            got8 = fl.ffn_half_bwd_cuda(w_x2, go, p)
            again8 = fl.ffn_half_bwd_cuda(w_x2, go, p)
            want8 = fl.ffn_half_bwd_plain(w_x2, go, p)
            torch.cuda.synchronize()
            e8 = []
            for name, a, b in zip(("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), got8, want8):
                e, ok = _err(a, b, dtype, fused_tol(dtype, b, summed=name != "dx2"))
                check(ok, f"ffn_half_bwd {name} disagrees with its plain version ({dtype}, "
                          f"causal={causal}): max abs err {e}")
                e8.append(e)
            check(all(torch.equal(a, b) for a, b in zip(got8, again8)),
                  f"ffn_half_bwd ({dtype}): two calls differ")
            dx2 = want8[0]
            got9 = fl.attn_half_bwd_cuda(tok, dx2, p, bias, causal, 0, na)
            again9 = fl.attn_half_bwd_cuda(tok, dx2, p, bias, causal, 0, na)
            want9 = fl.attn_half_bwd_plain(tok, dx2, p, bias, causal, 0, na)
            torch.cuda.synchronize()
            e9 = []
            for name, a, b in zip(("dy", "dwqkv", "dproj", "dbias"), got9, want9):
                e, ok = _err(a, b, dtype, fused_tol(dtype, b, summed=name != "dy"))
                check(ok, f"attn_half_bwd {name} disagrees with its plain version ({dtype}, "
                          f"causal={causal}): max abs err {e}")
                e9.append(e)
            check(all(torch.equal(a, b) for a, b in zip(got9, again9)),
                  f"attn_half_bwd ({dtype}, causal={causal}): two calls differ")
            print(f"fused kernels {dtype} causal={causal} ({shape}): max_abs_err kernel 7 out "
                  f"{e7[0]:.3g} x2 {e7[1]:.3g} (|out| <= {float(w_out.float().abs().max()):.3g}); "
                  f"kernel 8 " + " ".join(f"{k} {e:.3g}" for k, e in zip(
                      ("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), e8))
                  + "; kernel 9 " + " ".join(f"{k} {e:.3g}" for k, e in zip(
                      ("dy", "dwqkv", "dproj", "dbias"), e9)) + "; two calls bit-identical")
            for k, e in ((7, e7), (8, e8), (9, e9)):
                errs[k] = max(errs[k], *e)
            del out, x2, alone, again, w_out, got8, again8, want8, got9, again9, want9

            # times: kernel, plain version, unfused layer
            x2s = [fl.fused_layer_tokens_plain(t, p, bias, causal, True)[1] for t, _ in sets]
            with torch.no_grad():
                t7 = time_both(card, [lambda x=x: fl.fused_layer_fwd_cuda(x[0], p, bias, causal, True)
                                      for x in sets],
                               [lambda x=x: fl.fused_layer_tokens_plain(x[0], p, bias, causal, True)
                                for x in sets], 6, "kernel 7 ")
                u7 = device_ms([lambda x=x: ffn_tokens(mha_tokens(x[0], p, bias, causal), p)
                                for x in sets], 6)
                t8 = time_both(card, [lambda x=x, y=y: fl.ffn_half_bwd_cuda(y, x[1], p)
                                      for x, y in zip(sets, x2s)],
                               [lambda x=x, y=y: fl.ffn_half_bwd_plain(y, x[1], p)
                                for x, y in zip(sets, x2s)], 6, "kernel 8 ")
                t9 = time_both(card, [lambda x=x: fl.attn_half_bwd_cuda(x[0], x[1], p, bias, causal,
                                                                         0, na) for x in sets],
                               [lambda x=x: fl.attn_half_bwd_plain(x[0], x[1], p, bias, causal,
                                                                    0, na) for x in sets], 6,
                               "kernel 9 ")
            # a whole layer's forward + backward by CUDA events around eager
            # calls: the fused Function (kernels 7, 8, 9 and the LN tail) and
            # the unfused layer (kernels 1 and 10, the library's GEMMs)
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}

            def layer_step(fn, x):
                tk = x[0].detach().requires_grad_(True)
                b_ = relative_bias(leaves["dt_bank"], leaves["dh_bank"], leaves["dw_bank"], block)
                torch.autograd.grad(fn(tk, leaves, b_, causal), [tk, *leaves.values()], x[1])

            unfused = lambda tk, pp, b_, c: ffn_tokens(mha_tokens(tk, pp, b_, c), pp)
            fb_fused = host_ms([lambda x=x: layer_step(fl.fused_block_layer, x) for x in sets], 6)
            fb_unfused = host_ms([lambda x=x: layer_step(unfused, x) for x in sets], 6)
            print(f"  layer times {dtype} causal={causal} [{card}]: forward kernel 7 {t7[0]:.4f} ms, "
                  f"plain {t7[1]:.4f}, unfused layer {u7:.4f}; kernel 8 {t8[0]:.4f}, plain "
                  f"{t8[1]:.4f}; kernel 9 {t9[0]:.4f}, plain {t9[1]:.4f}; forward + backward of "
                  f"one layer by events: fused {fb_fused:.4f} ms, unfused {fb_unfused:.4f} ms")
            res[(dtype, causal)] = {7: t7, 8: t8, 9: t9, "unfused_fwd": u7,
                                    "fb_fused": fb_fused, "fb_unfused": fb_unfused}
            del x2s, leaves
        res[dtype] = errs

    # bounds, bf16, from the shapes: each input read once, each output
    # written once; the products the functions need
    wide, el = 3 * na * da, 2
    w_bytes = (d * wide + na * da * d + 2 * d * d + 6 * d) * el
    bias_b = na * n * n * 4
    attn = nb * na * n * n * da  # multiply-adds of one score-space product
    bounds = {
        7: bound_ms("bfloat16", 3 * rows * d * el + w_bytes + bias_b,
                    2 * rows * d * wide + 4 * attn + 2 * rows * na * da * d + 4 * rows * d * d),
        8: bound_ms("bfloat16", 3 * rows * d * el + 2 * d * d * el + 2 * d * d * 4 + 8 * d * 4,
                    10 * rows * d * d),
        9: bound_ms("bfloat16", 3 * rows * d * el + (d * wide + na * da * d) * el + bias_b
                    + (d * wide + na * da * d) * 4 + bias_b,
                    2 * 3 * rows * d * wide + 2 * 2 * rows * na * da * d + 12 * attn),
    }
    print("  bounds bf16 (NVIDIA H100 SXM peaks: 3.35 TB/s, 989 TFLOP/s dense bf16): "
          + ", ".join(f"kernel {k} {b:.4f} ms ({by})" for k, (b, by) in bounds.items()))
    t = res[("bfloat16", False)]
    res["by_function"] = fused_by_function(card, p, bias, sets[0], {k: t[k][0] for k in (7, 8, 9)})
    return res, bounds


def fused_by_function(card, p, bias, inputs, whole):
    """Device time of one call each of kernels 7, 8 and 9 (bf16, not causal,
    after a warm-up call) by __global__ function (gemm_nt_wgmma by epilogue,
    ln_rows_bf16 by input type), from torch.profiler, held
    against `whole`, each call's device ms timed by CUDA-graph replay. Only
    the public wrappers are called (tools/ab_attention_torch.py runs this on
    another tree's package too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lvt_tpu_torch.ops import fused_layer as fl

    tok, go = inputs
    na = p["wq"].shape[0]
    x2 = fl.fused_layer_tokens_plain(tok, p, bias, False, True)[1]
    dx2 = fl.ffn_half_bwd_plain(x2, go, p)[0]
    calls = {7: lambda: fl.fused_layer_fwd_cuda(tok, p, bias, False, True),
             8: lambda: fl.ffn_half_bwd_cuda(x2, go, p),
             9: lambda: fl.attn_half_bwd_cuda(tok, dx2, p, bias, False, 0, na)}
    out = {}
    for k, call in calls.items():
        call()
        # after many earlier profiler sessions and CUDA graphs in one process,
        # a session now and then records no device activity, or durations that
        # do not add up to the call: try again, and say so if none agrees
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                name = e.name[5:] if e.name.startswith("void ") else e.name
                name = name.replace("(anonymous namespace)::", "")
                short = re.split(r"[<(]", name)[0].split("::")[-1]
                if short in TEMPLATE_NAMES:  # the epilogue or input type of each launch
                    arg = re.match(r"[^<(]*<([^<>]*)>", name)
                    short += f"<{arg.group(1).split('::')[-1]}>" if arg else ""
                tot, cnt = by_name.get(short, (0.0, 0))
                by_name[short] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
            total = sum(t for t, _ in by_name.values())
            agrees = abs(total - whole[k]) <= 0.2 * whole[k]
            if agrees:
                break
        out[k] = {name: t for name, (t, _) in by_name.items()} if agrees else None
        print(f"  kernel {k} bf16 by __global__ function, one call under torch.profiler [{card}]: "
              + ", ".join(f"{name} {t:.4f} ms ({c}x)" for name, (t, c) in
                          sorted(by_name.items(), key=lambda kv: -kv[1][0]))
              + f"; total {total:.4f} ms"
              + ("" if agrees else f", not {whole[k]:.4f} as timed: this reading is not used"))
    return out


def _write_latents(root, n_videos, seed):
    """Latent videos in the CodesExtractor layout, <root>/video_<i>/<f>.npy,
    (nc, 16, 16) codes each, drawn from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d)
        for f, frame in enumerate(rng.integers(0, 512, (T_FRAMES, 4, 16, 16))):
            np.save(os.path.join(d, f"{f}.npy"), frame)


def _train_kernels():
    """The wrappers whose launches a train step is held to: kernels 1, 10, 7, 8, 9."""
    from lvt_tpu_torch.ops.attention import block_attention_bwd_cuda, block_attention_fwd_cuda
    from lvt_tpu_torch.ops.fused_layer import (attn_half_bwd_cuda, ffn_half_bwd_cuda,
                                               fused_layer_fwd_cuda)

    return (block_attention_fwd_cuda, block_attention_bwd_cuda, fused_layer_fwd_cuda,
            ffn_half_bwd_cuda, attn_half_bwd_cuda)


def phase_train(card, unfused=True, keep=None):
    """DSFVT training through tools/train_net_torch.py's main, then --resume,
    with the fused layer (DSFVT's defaults) and, unless ``unfused`` is
    False, with TPU.FUSED_LAYER False; per-step launch counts and times
    recorded around Trainer.train_step. ``keep``: a path that the fused run's
    OUTPUT_DIR is moved to (phase 17 evaluates its checkpoint)."""
    import shutil
    import tempfile

    from lvt_tpu_torch.data.datasets.latents import register_latents

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        _write_latents(os.path.join(tmp, "latents"), 128, 0)
        register_latents("chip_smoke_latents", os.path.join(tmp, "latents"))
        print(f"train data: 128 latent videos of {T_FRAMES} frames written in "
              f"{time.perf_counter() - t0:.2f} s")
        fused = _train_run(card, os.path.join(tmp, "fused"), True, TRAIN_STEPS, RESUME_STEPS)
        if keep:
            shutil.move(os.path.join(tmp, "fused"), keep)
        if not unfused:
            return fused, None
        unfused = _train_run(card, os.path.join(tmp, "unfused"), False, TRAIN_STEPS // 2,
                             RESUME_STEPS // 2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train DSFVT b=64 bf16 [{card}]: fused {fused['sec']:.4f} s/step, "
          f"{fused['videos_per_s']:.2f} videos/s, device busy {fused['busy_ms']:.2f} ms in "
          f"{fused['activities']} activities; unfused {unfused['sec']:.4f} s/step, "
          f"{unfused['videos_per_s']:.2f} videos/s, device busy {unfused['busy_ms']:.2f} ms in "
          f"{unfused['activities']} activities")
    return fused, unfused


def _train_run(card, out, fused, n_steps, n_resume):
    """One run of the training CLI's main and its --resume. Returns the
    launch counts of the first run by kernel and the step's times."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.engine.trainer import Trainer

    kernels = _train_kernels()
    want = (0, 0, 16, 16, 16) if fused else (32, 16, 0, 0, 0)
    label = "TPU.FUSED_LAYER True (the default)" if fused else "remat FUSED_LAYER False"
    steps, profiled = [], []
    inner = Trainer.train_step

    def recorded(self, batch):
        torch.cuda.synchronize()
        c0 = [k.launches for k in kernels]
        if len(steps) == n_steps + n_resume - 1:  # the last step, outside the medians
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                metrics = inner(self, batch)
                loss = float(metrics["loss_cross_entropy"])
                profiled.append((time.perf_counter() - t0, prof))
        else:
            t0 = time.perf_counter()
            metrics = inner(self, batch)
            loss = float(metrics["loss_cross_entropy"])  # synchronizes
        steps.append((time.perf_counter() - t0, loss,
                      tuple(k.launches - c for k, c in zip(kernels, c0)), t0))
        return metrics

    # DSFVT's defaults when fused: no TPU.FUSED_LAYER override
    opts = ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
            *([] if fused else ["TPU.FUSED_LAYER", "False"]),
            "SOLVER.CHECKPOINT_PERIOD", str(n_steps // 2),
            "DATASETS.TRAIN", "('chip_smoke_latents',)", "DATALOADER.NUM_WORKERS", "8",
            "OUTPUT_DIR", out]
    parse = default_argument_parser().parse_args
    try:
        Trainer.train_step = recorded
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(opts + ["SOLVER.MAX_ITER", str(n_steps)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(k.launches for k in kernels)
        peak = torch.cuda.max_memory_allocated()
        check(tr.model.fused == fused, f"train: model.fused is {tr.model.fused}, want {fused}")
        check(tr.state.step == n_steps and len(steps) == n_steps,
              f"train: {tr.state.step} steps taken, want {n_steps}")
        check(sorted(os.listdir(os.path.join(out, "checkpoints"))) ==
              sorted([f"ckpt_{n_steps // 2}.pt", f"ckpt_{n_steps}.pt"]),
              f"train: checkpoints {os.listdir(os.path.join(out, 'checkpoints'))}")
        tr2 = train_net_torch.main(parse(["--resume"] + opts + [
            "SOLVER.MAX_ITER", str(n_steps + n_resume)]))
        check(tr2.start_iter == n_steps and tr2.state.step == n_steps + n_resume,
              f"resume: started at {tr2.start_iter}, ended at {tr2.state.step}")
    finally:
        Trainer.train_step = inner
    losses = [s[1] for s in steps]
    check(all(np.isfinite(losses)), f"train: non-finite losses {losses}")
    per_step = {s[2] for s in steps}
    check(per_step == {want}, f"train ({label}): kernel launches per step (kernels 1, 10, 7, 8, "
                              f"9) {sorted(per_step)}, want exactly {want}")
    sec = float(np.median([s[0] for s in steps[3:n_steps]]))
    # an iteration: from one step's start to the next's (data, step, hooks)
    it_sec = float(np.median([b[3] - a[3] for a, b in zip(steps[3:n_steps - 1],
                                                           steps[4:n_steps])]))
    batch = tr.cfg.SOLVER.IMS_PER_BATCH
    print(f"train DSFVT b={batch} bf16 {label} [{card}]: {n_steps} steps in "
          f"{wall:.2f} s with set-up; median {sec:.4f} s/step over steps 4-{n_steps} "
          f"(train_step, synchronized), {it_sec:.4f} s/iteration (with data and hooks) = "
          f"{batch / it_sec:.2f} videos/s; first step {steps[0][0]:.3f} s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; launches per step (kernels 1, 10, 7, 8, 9) {want} (run: "
          f"{launches}); loss {losses[0]:.4f} -> {losses[n_steps - 1]:.4f}; "
          f"resumed at {n_steps}, {n_resume} more steps, loss {losses[-1]:.4f}")
    check(len(profiled) == 1, "train: the last resumed step was not profiled")
    busy, activities = _print_step_profile(card, batch, sec, *profiled[0])
    return {"launches": launches, "sec": sec, "it_sec": it_sec, "videos_per_s": batch / it_sec,
            "peak": peak, "busy_ms": busy, "activities": activities}


def _print_step_profile(card, batch, step_sec, wall, prof, what="DSFVT"):
    """Device time of one train step by kernel, with each __global__
    function of the hand-written kernels on its own. The
    busy share is given against the profiled step's wall time (the
    profiler's own per-launch cost included) and the median unprofiled
    step, ``step_sec``."""
    import torch

    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    print(f"profile, one train step {what} b={batch} bf16 [{card}]: wall {wall:.4f} s "
          f"under the profiler, device busy {busy:.2f} ms = {100 * busy / (1e3 * wall):.1f}% "
          f"of it, {100 * busy / (1e3 * step_sec):.1f}% of the median step ({step_sec:.4f} s); "
          f"{len(kern)} device activities")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot:9.3f} ms {cnt:5d}x  {name[:110]}")
    # the hand-written kernels' __global__ functions: the attention device
    # code (shared by kernels 1, 10 and, inside the fused layer, 7 and 9), the
    # fixed-order reduction (kernels 8, 9, 10), the fused layer's own (in
    # bf16: the LN passes ln_rows_bf16 and ln_bwd_rows; gemm_nt_wgmma with the
    # FFN epilogues of kernels 7 and 8, and with the plain store for the QKV,
    # do and dy products; proj_ffn and ffn_bwd_rows where a tree still has
    # them), and kernel 6's. A function counts in the first group whose key
    # its name holds.
    groups = (("attention forward", ("block_attention_",)), ("query tiles", ("::bwd_rows_",)),
              ("key tiles", ("::bwd_keys_",)), ("fixed-order reductions", ("dbias_reduce",)),
              ("ln_qkv", ("ln_qkv",)), ("ln_rows_bf16", ("ln_rows_bf16",)),
              ("ln_bwd_rows", ("ln_bwd_rows",)), ("proj_ffn", ("proj_ffn",)),
              ("ffn_bwd_rows", ("ffn_bwd_rows",)),
              ("gemm_nt FFN epilogues", ("::Ffn", "::StoreF32>")), ("gemm_nt", ("gemm_nt",)),
              ("gemm_tn", ("gemm_tn",)), ("nearest_indices (kernel 6)", ("nearest_indices_kernel",)))
    sums = {label: (0.0, 0) for label, _ in groups}
    for name, (t, c) in by_name.items():
        label = next((lb for lb, keys in groups if any(k in name for k in keys)), None)
        if label is not None:
            sums[label] = (sums[label][0] + t, sums[label][1] + c)
    print("  hand-written kernels per step: " + ", ".join(
        f"{label} {t:.3f} ms ({c}x)" for label, (t, c) in sums.items() if c)
        + f"; total {sum(t for t, _ in sums.values()):.3f} ms")
    return busy, len(kern)


def phase_train_agree(card):
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import VideoTransformer

    kernels = _train_kernels()
    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    vt = VideoTransformer(cfg)
    check(vt.fused, "train agree: DSFVT's default TPU.FUSED_LAYER is not True")
    params, _ = vt.init(torch.Generator().manual_seed(2))
    video = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 4, T_FRAMES, 16, 16)))
    si = torch.tensor([1, 9])
    res = {}
    for name, device, fused, tf32 in (
            ("cpu", "cpu", False, False), ("card", "cuda", False, False),
            ("tf32", "cuda", False, True), ("cpu fused", "cpu", True, False),
            ("card fused", "cuda", True, False), ("tf32 fused", "cuda", True, True)):
        p = copy.deepcopy(to_device(params, device))  # leaves of their own
        for leaf in flatten(p).values():
            leaf.requires_grad_(True)
        vt.fused = fused
        before = [k.launches for k in kernels]
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        try:
            loss, _ = vt.loss(p, {"video": video.to(device)}, slice_idx=si)
            loss.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        res[name] = (float(loss.detach()), {k: v.grad.cpu() for k, v in flatten(p).items()})
        took = tuple(k.launches - b for k, b in zip(kernels, before))
        want = ((0, 0, 16, 16, 16) if fused else (32, 16, 0, 0, 0)) if device == "cuda" \
            else (0, 0, 0, 0, 0)
        check(took == want, f"train agree ({name}): launches of kernels 1, 10, 7, 8, 9 {took}, "
                            f"want {want}")
        print(f"  train agree {name}: loss {res[name][0]:.6f}, "
              f"{time.perf_counter() - t0:.1f} s, launches {took}")

    def worst(grads, ref):
        floor = 1e-2 * max(float(g.norm()) for g in ref.values())
        ref_norm = float(torch.stack([g.norm() for g in ref.values()]).norm())
        rel = {k: float((grads[k] - g).norm()) / max(float(g.norm()), floor)
               for k, g in ref.items()}
        k = max(rel, key=rel.get)
        whole = float(torch.stack([(grads[k] - g).norm() for k, g in ref.items()]).norm())
        return rel[k], k, whole / ref_norm

    pairs = {"card vs cpu plain": ("card", "cpu"), "TF32 control": ("tf32", "cpu"),
             "fused card vs cpu plain": ("card fused", "cpu fused"),
             "fused vs unfused on the card": ("card fused", "card"),
             "fused with TF32 on": ("tf32 fused", "cpu fused")}
    got = {label: worst(res[a][1], res[b][1]) for label, (a, b) in pairs.items()}
    n_leaves = len(res["cpu"][1])
    print(f"train agree fp32 b=2 full width, one loss+backward [{card}], {n_leaves} gradient "
          f"leaves, worst leaf and whole gradient (relative Frobenius): " + "; ".join(
              f"{label} {e:.3g} ({k}), {w:.3g}" for label, (e, k, w) in got.items())
          + f"; bounds {GRAD_TOL:g} per leaf, {GRAD_TOL_WHOLE:g} whole; losses "
          + ", ".join(f"{k} {v[0]:.6f}" for k, v in res.items()))
    for a, b in (("card", "cpu"), ("card fused", "cpu fused"), ("card fused", "card")):
        check(abs(res[a][0] - res[b][0]) <= 1e-5 * abs(res[b][0]),
              f"train agree: loss {res[a][0]} ({a}), {res[b][0]} ({b})")
    for label in ("card vs cpu plain", "fused card vs cpu plain", "fused vs unfused on the card"):
        e, k, w = got[label]
        check(e <= GRAD_TOL, f"train agree, {label}: gradient {k} off by {e} (relative)")
        check(w <= GRAD_TOL_WHOLE, f"train agree, {label}: the whole gradient is off by {w} "
                                   "(relative)")
    # the fused step with TF32 on is printed, not held: its layers' products
    # are the kernels' own fp32 FMAs, which the switch does not reach
    e_tf32, _, w_tf32 = got["TF32 control"]
    check(e_tf32 > GRAD_TOL and w_tf32 > GRAD_TOL_WHOLE,
          f"train agree: the TF32 control reads {e_tf32} per leaf, {w_tf32} whole, within the "
          f"bounds {GRAD_TOL}, {GRAD_TOL_WHOLE}: they cannot tell TF32 from true fp32")
    return got


def _i8_kernels():
    """The wrappers of the quantized sampler's kernels: 3, 4, 5, 11."""
    from lvt_tpu_torch.ops.cache_attention import (cache_attention_i8_cuda,
                                                   decode_attention_i8_cuda,
                                                   decode_attention_i8_live_cuda)
    from lvt_tpu_torch.ops.quant import matmul_i8w_cuda

    return (decode_attention_i8_cuda, decode_attention_i8_live_cuda, cache_attention_i8_cuda,
            matmul_i8w_cuda)


def _i8_check(got, want, step, bf16_out):
    """(max abs err, share of (batch row, head) pairs off by more than
    rounding, within the per-output bound?) for kernels 3 and 4."""
    b, na = step.shape
    got, want = got.float().reshape(b, na, -1), want.float().reshape(b, na, -1)
    rounding = 1e-5 * want.abs().amax(dim=-1, keepdim=True)
    if bf16_out:
        rounding = rounding + 2 ** -7 * want.abs()
    diff = (got - want).abs()
    ok = bool(((diff <= I8_FLIPS * 127 * step[:, :, None] + rounding) & got.isfinite()).all())
    return float(diff.max()), float((diff > rounding).any(dim=-1).float().mean()), ok


def i8_sweep(card):
    """Kernels 3 and 4 at the rollout's batch sizes and live lengths: b in
    (1, 8, 16) x live in (16, 64, 128, 256), na=8, R=256, da=128, bf16
    scales and output: device times of each (through its (q8, sq) wrapper),
    of its fused entry (q and the new rows quantized in the launch, the
    sampler's call) and of kernel 2 over a bf16 cache of the same shape,
    over input sets of >= 64 MB together, beside the bound of the int8
    call; at b=8, live=256 (the rollout's shape) also the plain versions and
    fp32 scales. Only public wrappers are called, so that
    tools/ab_attention_torch.py can run this on another tree's package (a
    tree without the fused entries times none)."""
    import torch

    from lvt_tpu_torch.ops import cache_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(35)
    na, R, da, scale = 8, 256, 128, 128 ** -0.5
    fused = hasattr(ca, "decode_attention_i8_step_cuda")
    rows = []
    for b in (1, 8, 16):
        n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
        q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=dev, dtype=torch.int8)
        sq = 0.01 * torch.rand((b, na), generator=g, device=dev) + 1e-3
        qkv = torch.randn((b, 3, na, da), generator=g, device=dev).bfloat16()
        q = qkv[:, 0].contiguous()
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)

        def scales(dt):
            return (0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).to(dt)

        sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8), scales(torch.bfloat16),
                 torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8), scales(torch.bfloat16)) for _ in range(n_sets)]
        bf16 = [(torch.randn((b, na, R, da), generator=g, device=dev).bfloat16(),
                 torch.randn((b, na, R, da), generator=g, device=dev).bfloat16())
                for _ in range(max(4, n_sets // 2))]
        for live in (16, 64, 128, 256):
            r = {"b": b, "live": live}
            for k, fn in ((3, ca.decode_attention_i8_cuda), (4, ca.decode_attention_i8_live_cuda)):
                r[f"k{k}_ms"] = device_ms([lambda s=s: fn(q8, sq, *s, live, bias, scale)
                                           for s in sets], 200)
            for k, name in ((3, "decode_attention_i8_step_cuda"),
                            (4, "decode_attention_i8_live_step_cuda")):
                fn = getattr(ca, name, None)
                r[f"k{k}_step_ms"] = None if fn is None else device_ms(
                    [lambda s=s: fn(qkv[:, 0], qkv[:, 1:], *s, live, bias, scale) for s in sets],
                    200)
            r["k2_ms"] = device_ms([lambda c=c: ca.decode_attention_cuda(q, *c, live, bias, scale)
                                    for c in bf16], 200)
            r["bound_ms"], r["bound_by"] = i8_bound_ms(b, na, live, da)
            if (b, live) == (8, 256):
                for k, plain in ((3, ca.decode_attention_i8_plain),
                                 (4, ca.decode_attention_i8_live_plain)):
                    r[f"k{k}_plain_ms"] = device_ms(
                        [lambda s=s: plain(q8, sq, *s, live, bias, scale) for s in sets[:8]], 20)
                f32 = [(s[0], s[1].float(), s[2], s[3].float()) for s in sets]
                for k, fn in ((3, ca.decode_attention_i8_cuda),
                              (4, ca.decode_attention_i8_live_cuda)):
                    r[f"k{k}_fp32_ms"] = device_ms(
                        [lambda s=s: fn(q8, sq, *s, live, bias, scale, torch.bfloat16)
                         for s in f32], 200)
                del f32
            print(f"  kernels 3 and 4 sweep b={b} live={live} [{card}]: kernel 3 "
                  f"{r['k3_ms']:.4f} ms, kernel 4 {r['k4_ms']:.4f}; fused entries "
                  + (f"{r['k3_step_ms']:.4f} / {r['k4_step_ms']:.4f}" if fused else "none")
                  + f"; kernel 2 (bf16 cache) {r['k2_ms']:.4f}; bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})" + (f"; plain {r['k3_plain_ms']:.4f} / "
                                          f"{r['k4_plain_ms']:.4f}; fp32 scales "
                                          f"{r['k3_fp32_ms']:.4f} / {r['k4_fp32_ms']:.4f}"
                                          if (b, live) == (8, 256) else ""), flush=True)
            rows.append(r)
        del sets, bf16
    return rows


def i8_bound_ms(b, na, live, da):
    """bound_ms of one call of kernel 3 or 4 with bf16 scales and output: the
    live rows' int8 K and V and their scales, the bias row, q8 and sq (or
    the float q), the output; 4 integer operations per cache byte."""
    return bound_ms("int8", 2 * b * na * live * da + 2 * b * na * live * 2 + na * live * 4
                    + b * na * (da + 4) + b * na * da * 2, 4 * b * na * live * da)


def cache_sweep(card, k, fn, da, g, bs=(1, 16, 256), lives=(1, 64, 200, 256)):
    """Device ms of kernel 5 or 12 (``fn``, its CUDA wrapper) at na=8,
    R=256, fp32 scales, bf16 q and output, over b x live, each beside its
    bound_ms (the live rows' int8 K and V and their scales, the extra row,
    q and the output; 4 fp32 operations a cache byte); the calls cycle
    through input sets of >= 64 MB together."""
    import torch

    dev, na, R, scale = torch.device("cuda"), 8, 256, da ** -0.5
    rows = []
    for b in bs:
        n_sets = max(1, min(128, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
        sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev),
                 torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev))
                for _ in range(n_sets)]
        q = torch.randn((b, na, da), generator=g, device=dev).bfloat16()
        extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
        for live in lives:
            ms = device_ms([lambda s=s: fn(q, *s, extra, scale, live) for s in sets], 200)
            bd, by = bound_ms("float32", 2 * b * na * live * da + 2 * b * na * live * 4
                              + na * live * 4 + 2 * b * na * da * 2, 4 * b * na * live * da)
            rows.append({"b": b, "live": live, "da": da, "ms": ms, "bound_ms": bd,
                         "bound_by": by})
        print(f"kernel {k} sweep da={da} b={b} bf16 [{card}]: " + ", ".join(
            f"live={r['live']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})" for r in rows
            if r["b"] == b), flush=True)
        del sets
    return rows


def phase_i8_kernels(card, kernel2_ms=None):
    """Kernels 3, 4, 5 and 11 at the quantized sampler's shapes, each against
    its plain version with its control; device times over inputs larger than
    the L2."""
    import torch

    from lvt_tpu_torch.ops import cache_attention as ca
    from lvt_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(34)
    na, R, da = 8, 256, 128
    scale = da ** -0.5
    res = {}

    def cache_set(b, scale_dtype):
        k8, v8 = (torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).to(scale_dtype)
                  for _ in range(2))
        return k8, ks, v8, vs

    def poison(c, live):  # rows at or past live: what an earlier block run may have left
        k8, ks, v8, vs = (t.clone() for t in c)
        k8[:, :, live:], v8[:, :, live:] = 127, -128
        ks[:, :, live:], vs[:, :, live:] = 1e6, 1e6
        return k8, ks, v8, vs

    # ---- kernels 3 and 4
    pairs = {3: (ca.decode_attention_i8_cuda, ca.decode_attention_i8_plain),
             4: (ca.decode_attention_i8_live_cuda, ca.decode_attention_i8_live_plain)}
    errs = {3: 0.0, 4: 0.0}
    for b in (16, 8, 1):
        q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=dev, dtype=torch.int8)
        sq = 0.01 * torch.rand((b, na), generator=g, device=dev) + 1e-3
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            c0 = cache_set(b, dt)
            for live in (1, 64, 200, 256):
                c = poison(c0, live)
                step = ca.i8_weight_step(q8, sq, c[0], c[1], c[3], live, bias, scale)
                for k, (kernel, plain) in pairs.items():
                    got = kernel(q8, sq, *c, live, bias, scale, dt)
                    want = plain(q8, sq, *c, live, bias, scale, dt)
                    torch.cuda.synchronize()
                    e, off, ok = _i8_check(got, want, step, dtype == "bfloat16")
                    print(f"kernel {k} {kernel.__name__} scales/out {dtype} live={live} (b={b}, "
                          f"na={na}, R={R}, da={da}): max_abs_err {e:.3g}, pairs off by more than "
                          f"rounding {off:.3g} (|out| <= {float(want.float().abs().max()):.3g}, "
                          f"one step * 127 <= {127 * float(step.max()):.3g})")
                    check(ok and off <= I8_ROWS_OFF,
                          f"{kernel.__name__} disagrees with its plain version ({dtype}, b={b}, "
                          f"live={live}): max abs err {e}, pairs off {off}")
                    check(torch.equal(kernel(q8, sq, *c, live, bias, scale, dt), got),
                          f"{kernel.__name__}: two calls differ ({dtype}, b={b}, live={live})")
                    errs[k] = max(errs[k], e)
                    if live == 256 and b == 16 and dtype == "float32":
                        # control: the other kernel's plain version on the same inputs
                        twin = {3: 4, 4: 3}[k]
                        other = pairs[twin][1](q8, sq, *c, live, bias, scale, dt)
                        ce, coff, _ = _i8_check(got, other, step, False)
                        print(f"  control, kernel {k} against kernel {twin}'s plain version: "
                              f"max_abs_err {ce:.3g}, pairs off {coff:.3g}")
                        check(coff > I8_ROWS_OFF, f"kernel {k}: the control reads {coff} pairs "
                              f"off, within the bound {I8_ROWS_OFF}")
    sweep = i8_sweep(card)
    for k, name in ((3, "decode_attention_i8"), (4, "decode_attention_i8_live")):
        main = next(r for r in sweep if (r["b"], r["live"]) == (8, 256))  # the rollout's shape
        res[name] = dict(ms=main[f"k{k}_ms"], plain_ms=main[f"k{k}_plain_ms"], err=errs[k],
                         bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
                         kernel2_ms=main["k2_ms"], at="b=8, live=256, bf16 scales",
                         fp32_scales_ms=main[f"k{k}_fp32_ms"], fused_ms=main[f"k{k}_step_ms"],
                         sweep=[{key: r[key] for key in ("b", "live", f"k{k}_ms", f"k{k}_step_ms",
                                                         "k2_ms", "bound_ms")} for r in sweep])

    # ---- kernel 5: q in float, fp32 scales
    err5, t5 = 0.0, {}
    for b in (16, 1, 256):
        extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
        sets = [cache_set(b, torch.float32) for _ in range({16: 8, 1: 1, 256: 1}[b])]
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
            for live in (1, 64, 200, 256):
                k8, ks, v8, vs = sets[0]
                k8, v8 = k8.clone(), v8.clone()
                k8[:, :, live:], v8[:, :, live:] = 127, -128
                got = ca.cache_attention_i8_cuda(q, k8, ks, v8, vs, extra, scale, live)
                want = ca.cache_attention_i8_plain(q, k8, ks, v8, vs, extra, scale, live)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                tol = (K5_TOL * top, 2 ** -7 if dtype == "bfloat16" else 0.0)
                e, ok = _err(got, want, dtype, tol)
                print(f"kernel 5 cache_attention_i8 {dtype} live={live} (b={b}, na={na}, R={R}, "
                      f"da={da}): max_abs_err {e:.3g} (|out| <= {top:.3g})")
                check(ok, f"cache_attention_i8 disagrees with its plain version ({dtype}, b={b}, "
                          f"live={live}): max abs err {e}")
                err5 = max(err5, e)
                if live == 256 and b == 16 and dtype == "float32":
                    # control: weights rounded to bf16 before the V product
                    logits = torch.einsum("bad,bajd->baj", q, k8.float()) * scale * ks + extra
                    w = (torch.softmax(logits, -1).bfloat16().float() * vs)
                    ctl = torch.einsum("baj,bajd->bad", w, v8.float())
                    ce, cok = _err(got, ctl, dtype, tol)
                    print(f"  control, weights rounded to bf16 first: max_abs_err {ce:.3g}; "
                          f"bound {tol[0]:.3g}")
                    check(not cok, f"kernel 5: the control reads {ce}, within the bound {tol[0]}")
                if b == 16 and live == 256:
                    t5[dtype] = time_both(
                        card, [lambda s=s: ca.cache_attention_i8_cuda(q, *s, extra, scale, live)
                               for s in sets],
                        [lambda s=s: ca.cache_attention_i8_plain(q, *s, extra, scale, live)
                         for s in sets], 200, f"kernel 5 {dtype} b={b} live={live} ")
    nbytes = 2 * 16 * na * R * da + 2 * 16 * na * R * 4 + na * R * 4 + 2 * 16 * na * da * 2
    b5, by5 = bound_ms("float32", nbytes, 4 * 16 * na * R * da)
    print(f"  kernel 5 b=16 live={R}: bound {b5:.4f} ms ({by5}); kernel 2 at the same shape "
          f"{kernel2_ms} ms [{card}]")
    sweep5 = cache_sweep(card, 5, ca.cache_attention_i8_cuda, da, g)
    res["cache_attention_i8"] = dict(zip(("ms", "plain_ms"), t5["bfloat16"]), err=err5,
                                     bound_ms=b5, bound_by=by5, library_ms=None,
                                     kernel2_ms=kernel2_ms, fp32_ms=t5["float32"][0],
                                     sweep=sweep5)

    # ---- kernel 11 at DSFVT's three shapes (timed) and at a K that is no
    # power of two and rows past one block's 8 (checked only), bit-equal
    err11, shapes = 0.0, {}
    for K, N, timed in ((512, 3072, True), (1024, 512, True), (512, 512, True),
                        (1040, 512, False)):
        n_sets = min(256, -(-64 * 2 ** 20 // (K * N))) if timed else 1  # weights of 64 MB in all
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            sets = [quant.quantize_cols(torch.randn((K, N), generator=g, device=dev).to(dt), dt)
                    for _ in range(n_sets if dtype == "bfloat16" else 1)]
            sets = [(wi, wi.t().contiguous(), sw) for wi, sw in sets]
            for b in (1, 8, 16):
                y = torch.randn((b, K), generator=g, device=dev).to(dt)
                wi, wt, sw = sets[0]
                got = quant.matmul_i8w_cuda(y, wt, sw, dt)
                want = quant.matmul_i8w_plain(y, wt, sw, dt)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                tol = (K11_TOL * top, 2 ** -7 if dtype == "bfloat16" else K11_TOL)
                e, ok = _err(got, want, dtype, tol)
                ce, cok = _err(got, (y @ wi.to(dt)) * sw, dtype, tol)
                equal = torch.equal(got, want)
                print(f"kernel 11 matmul_i8w {dtype} ({b}, {K}) x ({K}, {N}): max_abs_err {e:.3g}"
                      f"{' (bit-equal)' if equal else ''} (|out| <= {top:.3g}); "
                      f"control, int8 weights without activation rounding: {ce:.3g}")
                check(ok and equal, f"matmul_i8w differs from its plain version ({dtype}, b={b}, "
                                    f"K={K}, N={N}): max abs err {e}")
                check(not cok, f"kernel 11: the control reads {ce}, within the bound")
                err11 = max(err11, e)
                if dtype == "bfloat16" and timed:
                    kd, pd = time_both(
                        card, [lambda s=s: quant.matmul_i8w_cuda(y, s[1], s[2], dt) for s in sets],
                        [lambda s=s: quant.matmul_i8w_plain(y, s[1], s[2], dt) for s in sets],
                        2 * n_sets, f"kernel 11 ({b}, {K}) x ({K}, {N}) ")
                    # yardsticks: the library's bf16 product on the unquantized
                    # size, and torch._int_mm (which wants more than 16 rows: the
                    # quantized rows padded to 32) plus the scaling
                    dense = device_ms([lambda s=s: y @ s[0].to(dt) for s in sets], 2 * n_sets)
                    y8, sy = quant.quantize_rows_i8(y)
                    y32 = torch.zeros((32, K), dtype=torch.int8, device=dev)
                    y32[:b] = y8
                    try:
                        int_mm = device_ms(
                            [lambda s=s: (torch._int_mm(y32, s[0])[:b].float() * sy
                                          * s[2].float()).to(dt) for s in sets], 2 * n_sets)
                    except RuntimeError as exc:  # a yardstick only: its shape limits vary
                        print(f"  torch._int_mm refused the shape: {exc}")
                        int_mm = None
                    bd, by = bound_ms("int8", K * N + b * K * 2 + N * 2 + b * N * 2, 2 * b * K * N)
                    print(f"  kernel 11 ({b}, {K}) x ({K}, {N}) bf16: bound {bd:.4f} ms ({by}); "
                          f"torch._int_mm on 32 padded rows + scaling "
                          f"{'refused' if int_mm is None else f'{int_mm:.4f} ms'}; bf16 matmul on "
                          f"the cast weight (the int8 mode) {dense:.4f} ms [{card}]")
                    shapes[f"{b}x{K}x{N}"] = {"ms": kd, "plain_ms": pd, "bound_ms": bd,
                                              "bound_by": by, "library_ms": int_mm,
                                              "cast_matmul_ms": dense}
            del sets
    main = shapes["8x512x3072"]
    res["matmul_i8w"] = dict(main, err=err11, shapes=shapes)
    return res


def phase_i8_fold(card):
    """Kernels 3 and 4 with the quantization of q and of the new cache row
    folded in (the sampler's call) against the PyTorch sequence they replace
    (quantize_cache_row, the row writes, quantize_rows_i8, the plain kernel)
    on the card: b in (1, 8, 16), live in (1, 64, 65, 256), na=8, R=256,
    da=128, the io dtype fp32 and bf16, rows from randn, rows of scale 1 at
    and next to x.5, and tiny rows. q8, sq, the cache rows and scales equal
    bit for bit (the rest of the cache untouched), the output within the
    kernel's bound of the sequence's, one launch a call. Returns the largest
    output error of each kernel."""
    import torch

    from lvt_tpu_torch.ops import cache_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(36)
    na, R, da, scale = 8, 256, 128, 128 ** -0.5
    errs = {3: 0.0, 4: 0.0}
    entries = {3: (ca.decode_attention_i8_step_cuda, ca.decode_attention_i8_step_plain),
               4: (ca.decode_attention_i8_live_step_cuda, ca.decode_attention_i8_live_step_plain)}
    checked = 0
    for b in (1, 8, 16):
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for rows in ("randn", "halves", "tiny"):
                qkv = torch.randn((b, 3, na, da), generator=g, device=dev)
                if rows == "halves":  # absmax 127: scale 1, the quotients the values
                    qkv = torch.randint(-126, 126, qkv.shape, generator=g, device=dev) + 0.5
                    qkv = qkv + torch.tensor([0.0, 2 ** -10, -2 ** -10], device=dev)[
                        torch.randint(0, 3, qkv.shape, generator=g, device=dev)]
                    qkv[..., 0] = 127.0
                elif rows == "tiny":
                    qkv = qkv * 1e-7
                qkv = qkv.to(dt)
                cache = [torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                                       dtype=torch.int8),
                         (0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).to(dt)]
                cache = [cache[0], cache[1], cache[0].flip(-1).contiguous(), cache[1].flip(-1)
                         .contiguous()]
                bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
                for live in (1, 64, 65, 256):
                    for k, (fused, plain) in entries.items():
                        mine = [t.clone() for t in cache]
                        theirs = [t.clone() for t in cache]
                        before = fused.launches
                        got, q8, sq = fused(qkv[:, 0], qkv[:, 1:], *mine, live, bias, scale, dt,
                                            q_out=True)
                        want, q8w, sqw = plain(qkv[:, 0], qkv[:, 1:], *theirs, live, bias, scale,
                                               dt, q_out=True)
                        torch.cuda.synchronize()
                        what = f"kernel {k} fused, {dtype} {rows} b={b} live={live}"
                        check(fused.launches == before + 1, f"{what}: launches")
                        check(torch.equal(q8, q8w) and torch.equal(sq, sqw),
                              f"{what}: q8 or sq differ from quantize_rows_i8's")
                        check(all(torch.equal(x, y) for x, y in zip(mine, theirs)),
                              f"{what}: the cache (k8, ks, v8, vs) differs from the row writes'")
                        step = ca.i8_weight_step(q8w, sqw, theirs[0], theirs[1], theirs[3], live,
                                                 bias, scale)
                        e, off, ok = _i8_check(got, want, step, dtype == "bfloat16")
                        check(ok and off <= I8_ROWS_OFF, f"{what}: output max abs err {e}, pairs "
                                                         f"off {off}")
                        errs[k] = max(errs[k], e)
                        checked += 1
    print(f"i8 fold [{card}]: {checked} fused calls of kernels 3 and 4: q8, sq, the new cache "
          f"rows and scales bit-equal to the PyTorch sequence's; outputs within the kernels' "
          f"bound, max_abs_err {errs[3]:.3g} / {errs[4]:.3g}")
    return errs


def _quantized_vt(vt, **knobs):
    """The same VideoTransformer with TEST.VT_SAMPLER keys set, as a config
    file or the command line would set them."""
    cfg = vt.cfg.clone()
    cfg.merge_from_list([x for k, v in knobs.items() for x in (f"TEST.VT_SAMPLER.{k}", v)])
    return type(vt)(cfg, T=vt.T, H=vt.H, W=vt.W)


I8_RUNS = (  # label, config keys, expected launches of kernels (2, 3, 4, 11) per rollout
    ("native", {}, (22528, 0, 0, 0)),
    ("int8 KV + xla", {"KV_DTYPE": "int8", "ATTN_IMPL": "xla"}, (0, 0, 0, 0)),
    ("int8 KV + pallas", {"KV_DTYPE": "int8", "ATTN_IMPL": "pallas"}, (0, 22528, 0, 0)),
    ("int8 KV + pallas-live", {"KV_DTYPE": "int8", "ATTN_IMPL": "pallas-live"},
     (0, 0, 22528, 0)),
    ("int8 KV + pallas + int8-pallas weights",
     {"KV_DTYPE": "int8", "ATTN_IMPL": "pallas", "WEIGHT_DTYPE": "int8-pallas"},
     (0, 22528, 0, 90112)),
)


def phase_main_i8(card, models):
    """The quantized sampler at full width through generate(): b=8, bf16, all
    11 sampled frames, greedy, each row from differently shifted priming
    frames. Returns the launches of kernels 3, 4 and 11, each from the run
    that was driven with the counts at 0, and the model of each run by label
    (its slice graph captured)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    from lvt_tpu_torch.ops import cache_attention as ca

    k3, k4, _, k11 = _i8_kernels()
    # kernels 2, 3, 4 and 11: each kernel's wrappers (3 and 4 with and
    # without the fold; the sampler calls the fused ones, where the tree has
    # them: tools/ab_attention_torch.py runs this on a parent tree too)
    steps = tuple(getattr(ca, n, None) for n in ("decode_attention_i8_step_cuda",
                                                 "decode_attention_i8_live_step_cuda"))
    counted = ((decode_attention_cuda,), tuple(w for w in (k3, steps[0]) if w),
               tuple(w for w in (k4, steps[1]) if w), (k11,))
    vqvae, vq_params, vq_state, vt, vt_params = models
    dev = torch.device("cuda")
    frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"), N_PRIME))
    b = 8
    frames = torch.stack([torch.roll(frames, (3 * i, 5 * i), (1, 2)) for i in range(b)]).to(dev)
    n_slices = T_FRAMES - N_PRIME
    out, launches, used = {}, {}, {}
    for label, knobs, want in I8_RUNS:
        model = _quantized_vt(vt, **knobs) if knobs else vt
        for k in sum(counted, (block_attention_fwd_cuda,)):
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        caps = _captures()
        video, codes, primed, seconds = gvt.generate(vqvae, vq_params, vq_state, model, vt_params,
                                                     frames, N_PRIME, None, greedy=True)
        line = _rollout_line(seconds, caps, b, n_slices, torch.cuda.max_memory_allocated())
        took = tuple(sum(k.launches for k in group) for group in counted)
        _check_run(label, video, codes, primed, 512, b)
        fused = tuple(w.launches if w else want[1 + i] for i, w in enumerate(steps))
        check(took == want and block_attention_fwd_cuda.launches == n_slices * 8
              and fused == want[1:3],
              f"{label}: launches of kernels 2, 3, 4, 11 {took}, want exactly {want}, all of "
              f"kernels 3 and 4 fused (fused: {fused}); kernel 1 "
              f"{block_attention_fwd_cuda.launches}, want {n_slices * 8}")
        out[label], launches[label], used[label] = codes, took, model
        agree = float((codes[:, :, N_PRIME:] == out["native"][:, :, N_PRIME:]).float().mean())
        first = float((codes[:, :, N_PRIME] == out["native"][:, :, N_PRIME]).float().mean())
        print(f"main path batch {b} bf16 greedy, {label} [{card}]: {line}; launches of "
              f"kernels 2, 3, 4, 11 {took}; greedy codes equal to the native rollout's: "
              f"{agree:.4f} of all sampled, {first:.4f} of the first sampled frame")
        if hasattr(vt, "_slice_graph"):
            # the rollout's last slice again, the sampler alone, conditioned on
            # the rollout's own earlier frames: by the eager loop in every mode
            # (phase 11b profiles the native slice and the modes this phase
            # does not roll out), and natively also by a graph captured anew
            # (a model with an empty graph cache); memory measured alike: the
            # peak of allocated bytes, and the growth of reserved bytes (the
            # graph's private pool among them)
            s = model.cfg.TEST.VT_SAMPLER
            ways = [("eager loop", model)] + ([("graph, captured anew", _quantized_vt(vt))]
                                              if not knobs else [])
            for way, m in ways:
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = m.sample_video(vt_params, codes, n_prime=T_FRAMES - 1, greedy=True,
                                     kv_cache_dtype=s.KV_DTYPE, kv_seg_size=s.SEG,
                                     attn_impl=s.ATTN_IMPL, weight_dtype=s.WEIGHT_DTYPE,
                                     _eager=way == "eager loop")
                torch.cuda.synchronize()
                took_s = time.perf_counter() - t0
                check(torch.equal(got, codes), f"{label}, {way}: the last slice's greedy codes "
                                               "differ from the graph rollout's through "
                                               "generate()")
                print(f"main path batch {b} bf16 greedy, {label}, sampler alone, last slice, "
                      f"{way} [{card}]: {took_s:.3f} s; max_memory_allocated "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, reserved grew "
                      f"{(torch.cuda.max_memory_reserved() - reserved) / 2 ** 20:.1f} MiB; greedy "
                      "codes equal to the rollout's through generate()")
        if knobs:
            check(agree >= GREEDY_FLOOR, f"{label}: greedy agreement with the native rollout "
                                         f"{agree}, under the floor {GREEDY_FLOOR}")
    check(not torch.equal(out["int8 KV + pallas"], out["native"]),
          "the int8 rollout's codes equal the native ones: were the config keys read?")
    return (launches["int8 KV + pallas"][1], launches["int8 KV + pallas-live"][2],
            launches["int8 KV + pallas + int8-pallas weights"][3]), used


def phase_i8_rollouts(card):
    """Phase 11 and one profiled slice of every sampler mode (eager and, on
    a tree with the graph, as a graph), on models built as phase 4 builds
    them, priming codes from a numpy seed: the int8 rollouts alone, for
    tools/ab_attention_torch.py."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    dev = torch.device("cuda")
    models = gvt.build_models(cfg, 0, dev, torch.bfloat16)
    c = models[3].c
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        0, c.nv, size=(8, c.nc, T_FRAMES, 16, 16))).to(dev)
    _, vts = phase_main_i8(card, models)
    phase_slices(card, models, codes, vts=vts)


def phase_bench_slice(card, models):
    """bench.py's own program, one slice: DSFVT at b = 1024, bf16, int8 KV,
    attn_impl "xla", greedy, through the slice's CUDA graph (all 256
    pixels), and the same with mm_dtype "int8" (kernel 3's plain version):
    the capture's and one replay's seconds, the replay's device busy share,
    max_memory_allocated, codes in range."""
    import numpy as np
    import torch

    from lvt_tpu_torch.models.vt import vt_encode

    *_, vt, params = models
    c, plan, s = vt.c, vt.plan, N_PRIME
    b, dev = BENCH_BATCH, torch.device("cuda")
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, c.nv, size=(b, c.nc, T_FRAMES, 16, 16))).to(dev)
    thw = plan.slice_src[s].size
    primed = torch.zeros(thw, dtype=torch.bool, device=dev)
    with torch.no_grad():
        sidx = torch.full((b,), s, dtype=torch.int64, device=dev)
        ctx, sl, _ = vt.prepare_slices(codes, sidx)
        zl = vt_encode(params["netG"], c, ctx, sidx)
    for label, mm in (("xla", "native"), ("xla + int8 mm", "int8")):
        knobs = {"kv_dtype": "int8", "weight_dtype": "native", "mm_dtype": mm,
                 "attn_impl": "xla"}
        vt._slice_graph_slot = None  # the graph kept before, freed before the peak is read
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            t0 = time.perf_counter()
            graph = vt._slice_graph(params, zl, sl, primed, knobs, 1.0, True)
            capture = time.perf_counter() - t0
            out, wall, wall_prof, kern, *_ = _profiled(lambda: graph(zl, sl, primed))
        peak = torch.cuda.max_memory_allocated()
        busy = sum(us for _, us in kern) / 1e6
        check(tuple(out.shape) == tuple(sl.shape),
              f"bench slice, {label}: codes of shape {tuple(out.shape)}")
        check(int(out.min()) >= 0 and int(out.max()) < c.nv,
              f"bench slice, {label}: codes outside [0, {c.nv})")
        print(f"bench.py's program, one slice: DSFVT b={b} bf16 int8 KV {label} greedy, {thw} "
              f"pixels, graph [{card}]: captured in {capture:.3f} s (warm-up, one eager slice, "
              f"{graph.warmup_seconds:.3f} s); one replay {wall:.3f} s ({wall_prof:.3f} s under "
              f"the profiler), device busy {busy:.3f} s = {100 * busy / wall_prof:.1f}% of the "
              f"profiled wall time; {len(kern) / thw:.2f} device activities per pixel; "
              f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; codes in [0, {c.nv})")
        for name, (tot, cnt) in sorted(_by_name(kern).items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"  {tot:9.2f} ms {cnt:7d}x  {name[:110]}")
        graph = out = kern = None


def phase_agree_i8(card):
    """fp32, b=1, full width, one slice teacher-forced: every mode of the
    quantized sampler (SLICE_MODES: the kernel modes, and int8 KV with
    `xla`, `xla` + int8 mm and int8 weights, which run PyTorch's CUDA ops)
    on the card against the plain path on the CPU."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    dev = torch.device("cuda")
    *_, vt, params = gvt.build_models(cfg, 1, dev, torch.float32)
    video = np.random.default_rng(0).integers(0, vt.c.nv, size=(1, vt.c.nc, T_FRAMES, 16, 16))
    modes = {label: {"kv_dtype": "native", "weight_dtype": "native", "mm_dtype": "native",
                     "attn_impl": "xla", **knobs} for label, knobs in SLICE_MODES}
    out = {}
    for name, device, p in (("card", dev, params["netG"]),
                            ("cpu", torch.device("cpu"), to_device(params["netG"], "cpu"))):
        sidx = torch.full((len(video),), N_PRIME, dtype=torch.int64, device=device)
        ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video).to(device), sidx)
        with torch.no_grad():
            zl = vt_encode(p, vt.c, ctx, sidx)
            for label, knobs in modes.items():
                t0 = time.perf_counter()
                out[name, label] = sample_slice_incremental(
                    p, vt.c, vt.plan.slice_shape, zl, sl, None, np.ones(256, bool), 1.0,
                    teacher_logits=True, **knobs)[1].cpu()
                print(f"  agree i8 {name} {label}: {time.perf_counter() - t0:.1f} s")
    def rms(x):
        return float(x.pow(2).mean().sqrt())

    for label in list(modes)[1:]:
        gap = out["cpu", label] - out["cpu", "native"]
        err = out["card", label] - out["cpu", label]
        ctl = out["card", "native"] - out["cpu", label]
        bound = AGREE_I8[modes[label]["weight_dtype"]] * rms(gap)
        print(f"agree i8 fp32 b=1 full width, {label} [{card}]: teacher logits card vs cpu plain "
              f"rms {rms(err):.3g} (max {float(err.abs().max()):.3g}); the mode's gap to the "
              f"native sampler rms {rms(gap):.3g} (max {float(gap.abs().max()):.3g}); bound "
              f"{bound:.3g} rms; control, native logits on the card against this mode's: rms "
              f"{rms(ctl):.3g}")
        check(rms(err) <= bound, f"agree i8, {label}: card vs cpu rms {rms(err)}, bound {bound}")
        check(rms(ctl) > bound, f"agree i8, {label}: the control reads {rms(ctl)}, within the "
                                f"bound {bound}")


def _near_ties(got, want, z, codebook):
    """(rows that differ, rows among them that are no near-tie) of two index
    vectors over z (N, Dc) and codebook (K, Dc), by float64 distances."""
    from lvt_tpu_torch.ops.vq import index_differences

    return index_differences(got[:, None], want[:, None], z[:, None], codebook[None])


def _within_share(n_diff, n_far, total):
    """The near-tie rule: no far miss, and at most NEAR_TIE_SHARE of the
    indices (one, of a few) differing."""
    from lvt_tpu_torch.ops.vq import NEAR_TIE_SHARE

    return n_far == 0 and n_diff <= max(1, int(NEAR_TIE_SHARE * total))


def _indices_ok(got, want, z, codebook):
    n_diff, n_far = _near_ties(got, want, z, codebook)
    return n_diff, n_far, _within_share(n_diff, n_far, want.numel())


def _grouped_kernel(vq):
    """Kernel 6 over all sub-codebooks and its plain version. A tree from
    before the grouped launch (an A/B turn on a parent commit) has only the
    one-codebook wrapper: there the pair calls it once per sub-codebook."""
    import torch

    if hasattr(vq, "nearest_indices_grouped_cuda"):
        return vq.nearest_indices_grouped_cuda, vq.nearest_indices_grouped_plain

    def per_codebook(fn):
        return lambda z, cbs: torch.stack([fn(z[:, i, :], cbs[i]) for i in range(cbs.shape[0])],
                                          dim=1)
    return per_codebook(vq.nearest_indices_cuda), per_codebook(vq.nearest_indices_plain)


def phase_vq_kernel(card, models=None):
    """Kernel 6 against its plain version at PR-DVQVAE2's training shape (all
    four sub-codebooks in one launch) and Base-VQVAE's (one codebook, Dc =
    256), with ties, a control, determinism, times, and (given the generation
    models) the real z_e of example/*.png."""
    import torch

    from lvt_tpu_torch.ops import vq

    grouped, grouped_plain = _grouped_kernel(vq)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    K, worst = 512, 0
    for G, Dc in ((4, 64), (1, 256)):
        codebooks = torch.randn((G, K, Dc), generator=g, device=dev)
        for N in (1, 8192, 8192 + 37):
            for dtype in ("float32", "bfloat16"):
                for strided in (False, True):
                    # strided: every other sub-codebook of a wider z, read in place
                    zz = torch.randn((N, 2 * G if strided else G, Dc), generator=g,
                                     device=dev).to(getattr(torch, dtype))
                    z = zz[:, 1::2, :] if strided else zz
                    got, again = grouped(z, codebooks), grouped(z, codebooks)
                    want = grouped_plain(z, codebooks)
                    torch.cuda.synchronize()
                    check(got.dtype == torch.int32 and tuple(got.shape) == (N, G),
                          f"nearest_indices: output {got.dtype} {tuple(got.shape)}")
                    res = [_indices_ok(got[:, i], want[:, i], z[:, i, :], codebooks[i])
                           for i in range(G)]
                    n_diff, n_far = sum(r[0] for r in res), sum(r[1] for r in res)
                    worst = max(worst, n_diff)
                    print(f"kernel 6 nearest_indices {dtype} N={N} G={G} K={K} Dc={Dc} "
                          f"{'strided' if strided else 'contiguous'}: {n_diff} of {N * G} indices "
                          f"differ from the plain version's, {n_far} of them no near-tie; two "
                          "calls bit-identical")
                    check(all(r[2] for r in res),
                          f"nearest_indices disagrees with its plain version ({dtype}, N={N}, "
                          f"G={G}, Dc={Dc}, strided={strided}): {n_diff} differ, {n_far} no "
                          "near-tie")
                    check(torch.equal(got, again), "nearest_indices: two calls differ")
                    if G == 1:  # the one-codebook wrapper is the same kernel
                        check(torch.equal(vq.nearest_indices_cuda(z[:, 0, :], codebooks[0]),
                                          got[:, 0]),
                              "nearest_indices: the one-codebook call differs from the grouped one")
    # exact ties: four copies of every code, and rows of z that equal a code
    base = torch.randn((128, 64), generator=g, device=dev)
    codebook = base.repeat(4, 1)
    z = torch.cat([base[[5, 127, 0]], torch.randn((8192, 64), generator=g, device=dev)])
    got, want = vq.nearest_indices_cuda(z, codebook), vq.nearest_indices_plain(z, codebook)
    check(got[:3].tolist() == [5, 127, 0] and int(got.max()) < 128 and torch.equal(got, want),
          f"nearest_indices: ties do not go to the lowest index (max index {int(got.max())}, "
          f"{int((got != want).sum())} differ from the plain version)")
    print("kernel 6 ties (512 codes = 4 copies of 128; 3 rows of z equal a code): the lowest "
          "index everywhere, equal to the plain version")
    # control: the plain version on bf16-rounded z is another function
    codebook = torch.randn((K, 64), generator=g, device=dev)
    z = torch.randn((8192, 64), generator=g, device=dev)
    got = vq.nearest_indices_cuda(z, codebook)
    n_diff, n_far, ok = _indices_ok(got, vq.nearest_indices_plain(z.bfloat16(), codebook), z,
                                    codebook)
    print(f"  control, the plain version on bf16-rounded z: {n_diff} of 8192 differ, {n_far} no "
          "near-tie")
    check(not ok, "nearest_indices: the control passes the near-tie check")

    # times at the training shapes: z_e of one PR-DVQVAE2 step, (8192, 4,
    # 64), all sub-codebooks in one call, read in place, and Base-VQVAE's
    # (8192, 1, 256); 8 sets (64 MB in fp32) cycle
    times = {}
    for G, Dc, dtypes in ((4, 64, ("bfloat16", "float32")), (1, 256, ("float32", "bfloat16"))):
        codebooks = torch.randn((G, K, Dc), generator=g, device=dev)
        for dtype in dtypes:
            sets = [torch.randn((8192, G, Dc), generator=g, device=dev).to(getattr(torch, dtype))
                    for _ in range(8)]
            kd, pd = time_both(card, [lambda s=s: grouped(s, codebooks) for s in sets],
                               [lambda s=s: grouped_plain(s, codebooks) for s in sets],
                               64, f"kernel 6 {dtype} N=8192 G={G} K={K} Dc={Dc} ")
            lib = device_ms([lambda s=s: [torch.cdist(s[:, i, :].float(), codebooks[i]).argmin(1)
                                          for i in range(G)] for s in sets], 64)
            times[(G, dtype)] = (kd, pd, lib)
            del sets
    bounds = {G: bound_ms("float32", 8192 * G * Dc * 2 + G * K * Dc * 4 + 8192 * G * 4,
                          2 * 8192 * G * K * Dc) for G, Dc in ((4, 64), (1, 256))}
    for G, Dc in ((4, 64), (1, 256)):
        t = {d: times[(G, d)] for d in ("bfloat16", "float32")}
        print(f"  kernel 6 N=8192 G={G} K={K} Dc={Dc}: bound {bounds[G][0]:.4f} ms "
              f"({bounds[G][1]}: "
              f"2 N G K Dc operations at the non-tensor fp32 peak, "
              f"{peaks()[1]['float32'] / 1e12:.0f} TFLOP/s); kernel bf16 z {t['bfloat16'][0]:.4f} "
              f"ms, fp32 z {t['float32'][0]:.4f}; plain {t['bfloat16'][1]:.4f} / "
              f"{t['float32'][1]:.4f}; library yardstick {G} x torch.cdist(z, c).argmin(1) "
              f"{t['bfloat16'][2]:.4f} / {t['float32'][2]:.4f} [{card}]")

    if models is not None:
        _vq_real_z(card, models)
    m, m256 = times[(4, "bfloat16")], times[(1, "float32")]
    return {"err": float(worst), "ms": m[0], "plain_ms": m[1], "bound_ms": bounds[4][0],
            "bound_by": bounds[4][1], "library_ms": m[2],
            "fp32_ms": times[(4, "float32")][0], "fp32_plain_ms": times[(4, "float32")][1],
            "fp32_library_ms": times[(4, "float32")][2], "dc256_ms": m256[0],
            "dc256_plain_ms": m256[1], "dc256_library_ms": m256[2],
            "dc256_bound_ms": bounds[1][0], "dc256_bf16_ms": times[(1, "bfloat16")][0],
            "err_is": "indices that differ, all at near-ties"}


def _vq_real_z(card, models):
    """Kernel 6 on the real z_e of example/*.png, beside the plain
    version's indices."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.ops import vq

    dev = torch.device("cuda")
    vqvae, vq_params, vq_state = models[:3]
    frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"), N_PRIME))
    with torch.no_grad():
        z_e, _ = vqvae.encode_features(vq_params, vq_state,
                                       vqvae.normalize(frames.to(dev) / 255.0))
        plain = vq.encode_indices(z_e, vq_state["netC"], use_kernel=False)
        kernel = vq.encode_indices(z_e, vq_state["netC"], use_kernel=True)
    emb = vq_state["netC"]["embedding"]
    num, _, Dc = emb.shape
    z = z_e.reshape(-1, num, Dc)
    diffs = [_near_ties(kernel.reshape(-1, num)[:, i], plain.reshape(-1, num)[:, i], z[:, i, :],
                        emb[i]) for i in range(num)]
    n_diff, n_far = sum(d[0] for d in diffs), sum(d[1] for d in diffs)
    print(f"kernel 6 on the z_e of example/*.png (seeded random PR-DVQVAE2 weights, "
          f"{plain.numel()} indices): {n_diff} differ from the plain version's, {n_far} "
          "of them no near-tie")
    check(n_far == 0, f"nearest_indices on real z_e: {n_far} indices differ at no near-tie")


def _write_frames(root, n_videos, n_frames, seed, split="train"):
    """PNG frames of 64x64 in the BAIR layout, <root>/<split>/video_<v>/<f>.png:
    8x8 colour blocks that drift from frame to frame, plus noise, drawn from a
    numpy seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, split, f"video_{v}")
        os.makedirs(d)
        blocks = rng.uniform(0, 255, (8, 8, 3))
        for f in range(n_frames):
            blocks = np.clip(blocks + rng.normal(0, 12, blocks.shape), 0, 255)
            frame = np.kron(blocks, np.ones((8, 8, 1))) + rng.normal(0, 6, (64, 64, 3))
            Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{f}.png"))


def phase_vqvae_train(card, keep=None):
    """PR-DVQVAE2 training through tools/train_net_torch.py's main at full
    width, then --resume; per-step launches of kernel 6 and times recorded
    around Trainer.train_step. ``keep``: a path that the run's OUTPUT_DIR is
    moved to (phase 17 evaluates its checkpoint)."""
    import shutil
    import tempfile
    from contextlib import nullcontext

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.data.datasets.bair import register_bair
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.ops.vq import nearest_indices_grouped_cuda

    n_steps, n_resume = VQ_TRAIN_STEPS, VQ_RESUME_STEPS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vqvae_")
    steps, profiled, resumed_from = [], [], []
    inner = Trainer.train_step

    def recorded(self, batch):
        if len(steps) == n_steps:  # the resumed run's first step: what it starts from
            resumed_from.append({k: v.clone() for k, v in flatten(self.state.model_state).items()})
        torch.cuda.synchronize()
        c0 = nearest_indices_grouped_cuda.launches
        last = len(steps) == n_steps + n_resume - 1  # outside the medians
        with profile(activities=[ProfilerActivity.CUDA]) if last else nullcontext() as prof:
            t0 = time.perf_counter()
            metrics = inner(self, batch)
            terms = {k: float(v) for k, v in metrics.items()}  # synchronizes
            took = time.perf_counter() - t0
        if last:
            profiled.append((took, prof))
        steps.append((took, terms, nearest_indices_grouped_cuda.launches - c0, t0))
        return metrics

    try:
        t0 = time.perf_counter()
        _write_frames(os.path.join(tmp, "frames"), VQ_FRAMES // T_FRAMES, T_FRAMES, 0)
        register_bair("chip_smoke_frames", os.path.join(tmp, "frames"), "train", True)
        print(f"vqvae train data: {VQ_FRAMES} PNG frames of 64x64 written in "
              f"{time.perf_counter() - t0:.2f} s")
        out = os.path.join(tmp, "out")
        # PR-DVQVAE2 as it stands: no override of the model, batch or solver
        opts = ["--config-file", os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"),
                "SOLVER.CHECKPOINT_PERIOD", str(n_steps // 2),
                "DATASETS.TRAIN", "('chip_smoke_frames',)", "DATALOADER.NUM_WORKERS", "8",
                "OUTPUT_DIR", out]
        parse = default_argument_parser().parse_args
        Trainer.train_step = recorded
        torch.cuda.reset_peak_memory_stats()
        nearest_indices_grouped_cuda.launches = 0
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(opts + ["SOLVER.MAX_ITER", str(n_steps)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = nearest_indices_grouped_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        cfg = tr.cfg
        check(cfg.MODEL.ENCODER.NF == 256 and cfg.MODEL.CODEBOOK.NUM == 4 and cfg.MODEL.CODEBOOK.EMA
              and cfg.SOLVER.IMS_PER_BATCH == 32 and tr.compute_dtype == torch.bfloat16,
              "vqvae train: not PR-DVQVAE2 at full width, batch 32, bf16 compute")
        check(tr.state.step == n_steps and len(steps) == n_steps,
              f"vqvae train: {tr.state.step} steps taken, want {n_steps}")
        check(sorted(os.listdir(os.path.join(out, "checkpoints"))) ==
              sorted([f"ckpt_{n_steps // 2}.pt", f"ckpt_{n_steps}.pt"]),
              f"vqvae train: checkpoints {os.listdir(os.path.join(out, 'checkpoints'))}")
        data_time = tr.storage.history("data_time").median(n_steps - 3)
        end_state = {k: v.clone() for k, v in flatten(tr.state.model_state).items()}
        fresh = flatten(tr.model.init(torch.Generator().manual_seed(tr.seed))[1])
        tr2 = train_net_torch.main(parse(["--resume"] + opts + [
            "SOLVER.MAX_ITER", str(n_steps + n_resume)]))
        check(tr2.start_iter == n_steps and tr2.state.step == n_steps + n_resume,
              f"vqvae resume: started at {tr2.start_iter}, ended at {tr2.state.step}")
        if keep:
            shutil.move(out, keep)
    finally:
        Trainer.train_step = inner
        shutil.rmtree(tmp, ignore_errors=True)

    for name in ("loss_reconstruction", "loss_commitment"):
        vals = [s[1].get(name, float("nan")) for s in steps]
        check(all(np.isfinite(vals)), f"vqvae train: non-finite {name} {vals}")
    per_step = {s[2] for s in steps}
    check(per_step == {1}, f"vqvae train: kernel-6 launches per step {sorted(per_step)}, want "
                           "exactly 1 (all sub-codebooks in one launch)")
    # the EMA codebook: moved, holding the mass 8192 (1 - 0.99^n) per sub-codebook
    check(not torch.equal(end_state["netC.embedding"].cpu(), fresh["netC.embedding"]),
          "vqvae train: the EMA embedding did not move")
    rows = cfg.SOLVER.IMS_PER_BATCH * 16 * 16
    mass, want_mass = end_state["netC.running_size"].sum(dim=1), rows * (1 - 0.99 ** n_steps)
    check(bool(((mass - want_mass).abs() <= 1e-4 * want_mass).all()),
          f"vqvae train: running_size sums to {mass.tolist()}, want {want_mass}")
    check(len(resumed_from) == 1 and all(torch.equal(v, end_state[k])
                                         for k, v in resumed_from[0].items()),
          "vqvae resume: the resumed run does not start from the saved model state")
    check(all(v.grad_fn is None and v.dtype == torch.float32 for v in end_state.values()),
          "vqvae train: the model state holds a graph or left fp32")
    used = (end_state["netC.running_size"] > 0).sum(dim=1).tolist()

    sec = float(np.median([s[0] for s in steps[3:n_steps]]))
    it_sec = float(np.median([b[3] - a[3] for a, b in zip(steps[3:n_steps - 1],
                                                           steps[4:n_steps])]))
    batch = cfg.SOLVER.IMS_PER_BATCH
    first, last = steps[0][1], steps[n_steps - 1][1]
    print(f"train PR-DVQVAE2 b={batch} bf16 64x64 [{card}]: {n_steps} steps in {wall:.2f} s with "
          f"set-up; median {sec:.4f} s/step over steps 4-{n_steps} (train_step, synchronized), "
          f"{it_sec:.4f} s/iteration (with data and hooks) = {batch / it_sec:.2f} frames/s; "
          f"data_time median {data_time:.4f} s; first step {steps[0][0]:.3f} s; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; kernel-6 launches per step 1 (run: "
          f"{launches}); loss_reconstruction {first['loss_reconstruction']:.4f} -> "
          f"{last['loss_reconstruction']:.4f}, loss_commitment {first['loss_commitment']:.5f} -> "
          f"{last['loss_commitment']:.5f}; codes hit per sub-codebook (of 512) {used}; "
          f"running_size mass {float(mass[0]):.2f} (want {want_mass:.2f}); resumed at {n_steps} "
          f"from the saved codebook, {n_resume} more steps")
    check(len(profiled) == 1, "vqvae train: the last resumed step was not profiled")
    busy, activities = _print_step_profile(card, batch, sec, *profiled[0], what="PR-DVQVAE2")
    return {"launches": launches, "sec": sec, "it_sec": it_sec, "frames_per_s": batch / it_sec,
            "peak": peak, "busy_ms": busy, "activities": activities}


def phase_vqvae_agree(card):
    """fp32, batch 4, PR-DVQVAE2 at full width, the same weights: one loss and
    backward on the card (kernel 6) against the plain path on the CPU."""
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.ops import vq
    from lvt_tpu_torch.ops.vq import nearest_indices_grouped_cuda

    model = VQVAE(gvt.load_config(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml")))
    params, state = model.init(torch.Generator().manual_seed(5))
    frames = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (4, 64, 64, 3))
                              .astype(np.float32))
    res, taken = {}, []
    inner = vq.quantize_st

    def recording(z_e, *a, **k):
        taken.append((z_e.detach().cpu(), inner(z_e, *a, **k)))
        return taken[-1][1]

    vq.quantize_st = recording
    try:
        for name, device, tf32 in (("cpu", "cpu", False), ("card", "cuda", False),
                                   ("tf32", "cuda", True)):
            p = copy.deepcopy(to_device(params, device))
            for leaf in flatten(p).values():
                leaf.requires_grad_(True)
            before = nearest_indices_grouped_cuda.launches
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            try:
                loss, (terms, new_state) = model.train_loss(
                    p, to_device(state, device), {"image": frames.to(device)})
                loss.backward()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            z_e, idx = taken[-1][0], taken[-1][1][2].cpu()
            res[name] = ({k: float(v.detach()) for k, v in terms.items()},
                         {k: v.grad.cpu() for k, v in flatten(p).items()},
                         {k: v.cpu() for k, v in flatten(new_state["netC"]).items()}, idx)
            took = nearest_indices_grouped_cuda.launches - before
            check(took == (1 if device == "cuda" else 0),
                  f"vqvae agree ({name}): {took} kernel-6 launches")
            if name == "cpu":
                z_cpu = z_e
    finally:
        vq.quantize_st = inner
    del z_e

    def worst(grads, ref):
        floor = 1e-2 * max(float(g.norm()) for g in ref.values())
        rel = {k: float((grads[k] - g).norm()) / max(float(g.norm()), floor)
               for k, g in ref.items()}
        k = max(rel, key=rel.get)
        whole = float(torch.stack([(grads[k] - g).norm() for k, g in ref.items()]).norm())
        return rel[k], k, whole / float(torch.stack([g.norm() for g in ref.values()]).norm())

    emb = state["netC"]["embedding"]
    out = {}
    for name in ("card", "tf32"):
        terms, grads, new_cb, idx = res[name]
        e, k, w = worst(grads, res["cpu"][1])
        # indices under the near-tie rule, by float64 distances of the CPU's z_e
        ref_idx = res["cpu"][3]
        diffs = [_near_ties(idx.reshape(-1, 4)[:, i], ref_idx.reshape(-1, 4)[:, i],
                            z_cpu.reshape(-1, 4, 64)[:, i, :], emb[i]) for i in range(4)]
        n_diff, n_far = sum(d[0] for d in diffs), sum(d[1] for d in diffs)
        # the new EMA state on the codes no differing index touches
        touched = torch.zeros((4, 512), dtype=torch.bool)
        for i in range(4):
            a, b = idx.reshape(-1, 4)[:, i].long(), ref_idx.reshape(-1, 4)[:, i].long()
            touched[i, a[a != b]] = True
            touched[i, b[a != b]] = True
        # codes the batch hit hold means of z_e (|.| ~ 1), the others the
        # initial sums over a denominator of ~eps (|.| ~ 1e2): each group of
        # embedding rows is held to its own largest value
        hit = res["cpu"][2]["running_size"] > 0
        state_err = 0.0
        for field, ref in res["cpu"][2].items():
            for rows in ((hit, ~hit) if field == "embedding" else (torch.ones_like(hit),)):
                keep = rows & ~touched
                keep = keep if ref.dim() == 2 else keep[:, :, None].expand_as(ref)
                if bool(keep.any()):
                    state_err = max(state_err, float((new_cb[field] - ref).abs()[keep].max())
                                    / float(ref.abs()[keep].max()))
        term_err = max(abs(terms[t] - v) / abs(v) for t, v in res["cpu"][0].items())
        out[name] = (e, k, w, n_diff, n_far, state_err, term_err)
    n_idx = res["cpu"][3].numel()
    print(f"vqvae agree fp32 b=4 full width, one loss+backward [{card}], "
          f"{len(res['cpu'][1])} gradient leaves: " + "; ".join(
              f"{label}: loss terms off by {o[6]:.3g} (relative), worst leaf {o[0]:.3g} ({o[1]}), "
              f"whole gradient {o[2]:.3g}, {o[3]} of {n_idx} indices differ ({o[4]} no near-tie), "
              f"new EMA state off by {o[5]:.3g} of its largest value"
              for label, o in (("card vs cpu plain", out["card"]),
                               ("TF32 control", out["tf32"])))
          + f"; bound {GRAD_TOL:g} per leaf and whole; losses cpu "
          + ", ".join(f"{k} {v:.6f}" for k, v in res["cpu"][0].items()))
    e, k, w, n_diff, n_far, state_err, term_err = out["card"]
    check(term_err <= 1e-5, f"vqvae agree: loss terms off by {term_err} (relative)")
    check(e <= GRAD_TOL, f"vqvae agree: gradient {k} off by {e} (relative)")
    check(w <= GRAD_TOL, f"vqvae agree: the whole gradient is off by {w} (relative)")
    check(n_far == 0 and n_diff <= max(1, int(VQ_AGREE_SHARE * n_idx)),
          f"vqvae agree: {n_diff} indices differ, {n_far} of them at no near-tie")
    check(state_err <= 1e-5, f"vqvae agree: the new EMA state is off by {state_err}")
    e, _, w = out["tf32"][:3]
    check(e > GRAD_TOL and w > GRAD_TOL,
          f"vqvae agree: the TF32 control reads {e} per leaf, {w} whole, within the bound "
          f"{GRAD_TOL}: it cannot tell TF32 from true fp32")


def phase_probe_kernel(card):
    """Kernel 12 against its plain version at the probe tool's shape and
    DSFVT's; then the tool's own timing run, with the launch count read
    around it."""
    import importlib.util

    import torch

    from lvt_tpu_torch.ops import cache_attention as ca

    spec = importlib.util.spec_from_file_location(
        "probe_decode_kernel_torch", os.path.join(ROOT, "tools", "probe_decode_kernel_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    err = 0.0
    for label, (b, na, R, da) in tool.SHAPES.items():
        scale = da ** -0.5
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k8, ks, v8, vs, extra = tool.make_inputs(12, b, na, R, da, dt, "cuda")
            extra = 0.5 * torch.randn_like(extra)  # no mask: `live` bounds the rows
            for live in (1, 64, 200, 256):
                k8p, v8p = k8.clone(), v8.clone()
                k8p[:, :, live:], v8p[:, :, live:] = 127, -128  # rows >= live are never read
                got = ca.decode_attention_i8kv_cuda(q, k8p, ks, v8p, vs, extra, scale, live)
                want = ca.decode_attention_i8kv_plain(q, k8p, ks, v8p, vs, extra, scale, live)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                # fp32: sums in another order, 1e-5 of the largest output. bf16:
                # one rounding of the output (2^-7 relative) plus two weights
                # whose fp32 values the two versions put on either side of a
                # bf16 boundary, each moving an output by ulp_bf16(w) * |v|
                logits = torch.einsum("bad,bajd->baj", q.float(), k8p[:, :, :live].float())
                w = torch.softmax(logits * scale * ks[:, :, :live] + extra[:, :, :live], -1) \
                    * vs[:, :, :live]
                tol = (1e-5 * top + (2 * 2 ** -8 * 127 * float(w.max())
                                     if dtype == "bfloat16" else 0.0),
                       2 ** -7 if dtype == "bfloat16" else 0.0)
                e, ok = _err(got, want, dtype, tol)
                print(f"kernel 12 decode_attention_i8kv {dtype} live={live} ({label}: b={b}, "
                      f"na={na}, R={R}, da={da}): max_abs_err {e:.3g} (|out| <= {top:.3g}, "
                      f"bound {tol[0]:.3g} + {tol[1]:.3g} relative)")
                check(ok, f"decode_attention_i8kv disagrees with its plain version ({label}, "
                          f"{dtype}, live={live}): max abs err {e}")
                err = max(err, e)
                if live == 256:
                    # control: kernel 3's scheme (int8 q and weights) on the same inputs
                    q8, sq = tool.quantize_q(q)
                    ctl = ca.decode_attention_i8_plain(q8, sq, k8p, ks, v8p, vs, live, extra[0],
                                                       scale, dt).reshape(want.shape)
                    ce, cok = _err(got, ctl, dtype, tol)
                    print(f"  control, kernel 3's scheme on the same inputs: max_abs_err {ce:.3g}")
                    check(not cok, f"kernel 12 ({label}, {dtype}): the control reads {ce}, within "
                                   "the bound")
    g = torch.Generator(device="cuda").manual_seed(16)
    sweep = [r for da in (16, 128) for r in cache_sweep(card, 12, ca.decode_attention_i8kv_cuda,
                                                        da, g)]
    ca.decode_attention_i8kv_cuda.launches = 0
    times = tool.bench(torch.bfloat16)
    launches = ca.decode_attention_i8kv_cuda.launches
    check(launches > 0, "the probe tool launched kernel 12 no time")
    b, na, R, da = tool.SHAPES["probe"]
    bd, by = bound_ms("bfloat16", 2 * b * na * R * da + 2 * b * na * R * 4 + na * R * 4
                      + 2 * b * na * da * 2, 4 * b * na * R * da)
    b2, na2, R2, da2 = tool.SHAPES["dsfvt"]
    bd2, _ = bound_ms("bfloat16", 2 * b2 * na2 * R2 * da2 + 2 * b2 * na2 * R2 * 4 + na2 * R2 * 4
                      + 2 * b2 * na2 * da2 * 2, 4 * b2 * na2 * R2 * da2)
    probe, dsfvt = times["probe"], times["dsfvt"]
    k2 = dsfvt["decode_attention (kernel 2, cache in the io dtype)"]
    k3 = dsfvt["decode_attention_i8 (kernel 3)"]
    print(f"  kernel 12 bf16 [{card}]: the probe's shape (b={b}, da={da}) "
          f"{probe['decode_attention_i8kv']:.4f} ms, plain {probe['plain']:.4f}, bound {bd:.4f} "
          f"({by}); DSFVT's shape (b={b2}, da={da2}) {dsfvt['decode_attention_i8kv']:.4f} ms, "
          f"plain {dsfvt['plain']:.4f}, bound {bd2:.4f}, kernel 2 {k2:.4f}, kernel 3 {k3:.4f}; no "
          f"single library call computes it; launches in the tool's run {launches}")
    return {"err": err, "ms": probe["decode_attention_i8kv"], "plain_ms": probe["plain"],
            "bound_ms": bd, "bound_by": by, "library_ms": None,
            "dsfvt_ms": dsfvt["decode_attention_i8kv"], "dsfvt_plain_ms": dsfvt["plain"],
            "dsfvt_bound_ms": bd2, "kernel2_ms": k2, "kernel3_ms": k3, "sweep": sweep}, launches


# Phase 17, "eval": the evaluation path at full width. Its test set: EVAL_VIDEOS
# videos of T_FRAMES 64x64 frames. Launches, stated before any run of it
# (models/vt.py logits_for_entire_video and sample_video): bits/dim
# teacher-forces all T_FRAMES slices of a video (DSFVT's stride 16, 1, 1: a
# frame a slice), each through 8 + 8 fused layers, one kernel-7 launch each
# and none of kernel 1; a rollout encodes each of its 11 sampled slices (8
# layers of kernel 1) and decodes 256 pixels x 8 layers (kernel 2).
EVAL_VIDEOS = 2  # cut from BAIR's 256 for the time limit
EVAL_K7_PER_VIDEO = T_FRAMES * (8 + 8)
EVAL_K1_PER_ROLLOUT = (T_FRAMES - N_PRIME) * 8
EVAL_K2_PER_ROLLOUT = (T_FRAMES - N_PRIME) * 256 * 8
# bits/dim, fp32, card vs the plain path on the CPU: PATH_TOL on each logit
# moves a cross-entropy (logsumexp minus one logit) by at most 2 x 2e-5 nats,
# 5.8e-5 bits
BITS_TOL = 6e-5
# reconstruction MSE, card vs CPU, relative: fp32 convolutions summed in
# other orders (~1e-6), a reconstruction moved by a near-tie code at most
MSE_TOL = 1e-4
# I3D logits, card vs CPU, fp32, against the largest: sums of up to 22,464
# terms (Mixed_5c's 3x3x3 over 832 channels) in another order through 22
# convolutions; measured ~2e-6 between lvt_tpu and the port on the CPU
I3D_TOL = 1e-4
# bits/dim of phase 8's DSFVT (24 steps from its init on uniform random codes,
# its training loss down to 6.2384 nats = log 512) over stage 1's latents: the
# model is close to uniform, so a hair above log2 512 (the cross-entropy of a
# near-uniform model on any data); above log2 512 + BITS_SLACK means a broken
# path
BITS_SLACK = 0.5


def _device_busy_ms(prof):
    """Device ms of a torch.profiler run (its raw CUDA records)."""
    import torch

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6


def _latent_tree(root):
    """{"video_<v>/<f>.npy": array} of a CodesExtractor tree."""
    import numpy as np

    return {os.path.relpath(os.path.join(d, f), root): np.load(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".npy")}


def _latent_near_ties(got, want, frames_root, vq_dir, vq_yaml):
    """(indices that differ, of them no float64 near-tie, indices) between two
    CodesExtractor trees of the same videos; z_e from the plain fp32 path on
    the CPU."""
    import numpy as np
    import torch

    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.evaluation.vt_sampler import load_vqvae_weights
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.utils.image import read_image

    n_diff = n_far = total = 0
    vq = None
    for video in sorted({os.path.dirname(k) for k in want}):
        g = np.stack([got[f"{video}/{f}.npy"] for f in range(T_FRAMES)])  # (T, nc, h, w)
        w = np.stack([want[f"{video}/{f}.npy"] for f in range(T_FRAMES)])
        total += w.size
        if np.array_equal(g, w):
            continue
        if vq is None:
            cfg = get_cfg()
            cfg.merge_from_file(vq_yaml)
            vq = VQVAE(cfg)
            p, st, _ = load_vqvae_weights(vq, *vq.init(torch.Generator().manual_seed(0)),
                                          vq_dir, "", "")
        x = np.stack([read_image(os.path.join(frames_root, "test", video, f"{f}.png"), "RGB")
                      for f in range(T_FRAMES)]).astype(np.float32)
        if cfg.INPUT.SCALE_TO_ZEROONE:
            x /= 255.0
        with torch.no_grad():
            z = vq.encode_features(p, st, vq.normalize(torch.from_numpy(x)))[0]
        emb = st["netC"]["embedding"]
        num, _, dc = emb.shape
        z = z.reshape(-1, num, dc)
        gi = torch.from_numpy(g.transpose(0, 2, 3, 1).reshape(-1, num))
        wi = torch.from_numpy(w.transpose(0, 2, 3, 1).reshape(-1, num))
        for c in range(num):
            d, f = _near_ties(gi[:, c], wi[:, c], z[:, c], emb[c])
            n_diff, n_far = n_diff + d, n_far + f
    return n_diff, n_far, total


def _i3d_agree(card):
    """i3d_apply on the card and on the CPU, fp32, on the same .npz (lvt_tpu's
    layout, weights from a numpy seed) and the same (2, 16, 224, 224, 3)
    video. Returns (max |card - cpu|, max |cpu|, the same with TF32 on,
    card ms a call, by CUDA events)."""
    import tempfile

    import numpy as np
    import torch

    from lvt_tpu_torch.evaluation.i3d import i3d_apply, init_i3d, load_i3d_npz

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(v.shape)

    rng = np.random.default_rng(17)
    arrays = {}
    for key, shape in flat(init_i3d(torch.Generator())):
        if key.endswith("/w"):  # (out, in, t, h, w) -> lvt_tpu's (t, h, w, in, out)
            o, i, *k = shape
            scale = 0.01 if key.startswith("Logits") else 1.0 / np.sqrt(i * np.prod(k))
            arrays[key] = rng.standard_normal((*k, i, o)) * scale
        elif key.endswith("/var"):
            arrays[key] = rng.uniform(0.5, 1.5, shape)
        else:  # beta, mean, b
            arrays[key] = rng.normal(0.0, 0.1, shape)
    video = rng.uniform(-1.0, 1.0, (2, T_FRAMES, 224, 224, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "i3d.npz")
        np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})
        params = {d: load_i3d_npz(path, d) for d in ("cuda", "cpu")}
    out = {}
    with torch.no_grad():
        out["cpu"] = i3d_apply(params["cpu"], torch.from_numpy(video))
        x = torch.from_numpy(video).cuda()
        out["card"] = i3d_apply(params["cuda"], x).cpu()
        ms = host_ms([lambda: i3d_apply(params["cuda"], x)], 3)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out["tf32"] = i3d_apply(params["cuda"], x).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    top = float(out["cpu"].abs().max())
    return (float((out["card"] - out["cpu"]).abs().max()), top,
            float((out["tf32"] - out["cpu"]).abs().max()), ms)


def phase_eval(card, vq_dir, vt_dir):
    """Evaluation at full width through tools/train_net_torch.py --eval-only:
    stage 1 (PR-DVQVAE2 from phase 14's OUTPUT_DIR ``vq_dir``: MSE and the
    latents of a test set written here), stage 2 (DSFVT from phase 8's fused
    OUTPUT_DIR ``vt_dir`` over those latents: bits/dim, sampled videos,
    FVD_stub, the paired VQ-VAE from ``vq_dir``) with exact launch counts and
    one rollout capture; card against CPU for both stages and for I3D; and
    EvalHook in a 4-step DSFVT training run. Returns {kernel: launches}:
    kernel 6's of stage 1, the others' of stage 2."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    import lvt_tpu_torch.engine.defaults as defaults
    from lvt_tpu_torch.data.datasets.bair import register_bair
    from lvt_tpu_torch.data.datasets.latents import register_latents
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda
    from lvt_tpu_torch.ops.fused_layer import fused_layer_fwd_cuda
    from lvt_tpu_torch.ops.vq import nearest_indices_grouped_cuda

    parse = default_argument_parser().parse_args
    main = train_net_torch.main
    vq_yaml = os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml")
    vt_yaml = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    paired = ["TEST.VT_SAMPLER.VQ_VAE.CFG", vq_yaml, "TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS",
              vq_dir, "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
              "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", ""]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # ---- the test set: bair_test_seq's layout
        t0 = time.perf_counter()
        frames_root = os.path.join(tmp, "frames")
        _write_frames(frames_root, EVAL_VIDEOS, T_FRAMES, 1, split="test")
        register_bair("chip_smoke_eval_seq", frames_root, "test", False)
        print(f"eval data: {EVAL_VIDEOS} test videos of {T_FRAMES} PNG frames of 64x64 written "
              f"in {time.perf_counter() - t0:.2f} s")

        # ---- stage 1: PR-DVQVAE2 --eval-only, MSE + CodesExtractor
        stage1 = ["--config-file", vq_yaml, "--eval-only", "DATASETS.TEST",
                  "('chip_smoke_eval_seq',)", "DATALOADER.NUM_WORKERS", "0"]
        k6 = nearest_indices_grouped_cuda.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res1 = main(parse(stage1 + ["OUTPUT_DIR", vq_dir]))
            torch.cuda.synchronize()
            sec1 = time.perf_counter() - t0
        peak1, busy1 = torch.cuda.max_memory_allocated() - held, _device_busy_ms(prof)
        mse = res1["reconstruction"]["MSE"]
        check(np.isfinite(mse), f"eval stage 1: MSE {mse}")
        k6 = nearest_indices_grouped_cuda.launches - k6
        check(k6 == EVAL_VIDEOS, f"eval stage 1: {k6} launches of kernel 6, want "
                                 f"{EVAL_VIDEOS} (encode_indices takes it, one a video)")
        codes_root = os.path.join(vq_dir, "inference", "chip_smoke_eval_seq")
        latents = _latent_tree(codes_root)
        want_files = {f"video_{v}/{f}.npy" for v in range(EVAL_VIDEOS) for f in range(T_FRAMES)}
        check(set(latents) == want_files, f"eval stage 1: latents {sorted(latents)[:4]}..., want "
                                          f"{EVAL_VIDEOS} x {T_FRAMES} files")
        for k, a in latents.items():
            check(a.shape == (4, 16, 16) and a.dtype == np.int32 and 0 <= a.min()
                  and a.max() < 512, f"eval stage 1: {k} {a.shape} {a.dtype} [{a.min()}, {a.max()}]")
        used = len(np.unique(np.stack(list(latents.values()))))
        print(f"eval stage 1 PR-DVQVAE2 --eval-only [{card}]: {EVAL_VIDEOS} videos in "
              f"{sec1:.2f} s with set-up (model, checkpoint, PNG reads), device busy "
              f"{busy1:.1f} ms ({100 * busy1 / 1e3 / sec1:.1f}%), max_memory_allocated "
              f"{peak1 / 2 ** 20:.1f} MiB above the {held / 2 ** 20:.0f} MiB earlier phases "
              f"hold; MSE {mse:.6g}; {len(latents)} latent files of (4, 16, "
              f"16) int32, {used} distinct codes")

        # ---- stage 2: DSFVT --eval-only, bits/dim + samples + FVD_stub
        register_latents("chip_smoke_eval_latents", codes_root)
        stage2 = ["--config-file", vt_yaml, "--eval-only", "DATASETS.TEST",
                  "('chip_smoke_eval_latents',)", "DATALOADER.NUM_WORKERS", "0", *paired]
        timed = {"bits": 0.0, "host": 0.0, "sample": 0.0}
        seen = []  # the first bits call, profiled again after the run
        inner_logits, inner_sample = (VideoTransformer.logits_for_entire_video,
                                      VideoTransformer.sample_video)

        def logits(self, *a, **k):
            if not seen:
                seen.append((self, a, k))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner_logits(self, *a, **k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = out.cpu()  # the host transfer, apart
            timed["bits"] += t1 - t0
            timed["host"] += time.perf_counter() - t1
            return out

        def sample(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner_sample(self, *a, **k)
            torch.cuda.synchronize()
            timed["sample"] += time.perf_counter() - t0
            return out

        counted = (fused_layer_fwd_cuda, block_attention_fwd_cuda, decode_attention_cuda)
        want = (EVAL_VIDEOS * EVAL_K7_PER_VIDEO, EVAL_VIDEOS * EVAL_K1_PER_ROLLOUT,
                EVAL_VIDEOS * EVAL_K2_PER_ROLLOUT)
        VideoTransformer.logits_for_entire_video, VideoTransformer.sample_video = logits, sample
        try:
            caps = _captures()
            for k in counted:
                k.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res2 = main(parse(stage2 + ["TEST.EVALUATORS", "BitsEvaluator,VTSampler,FVDEvaluator",
                                        "OUTPUT_DIR", vt_dir]))
            torch.cuda.synchronize()
            sec2 = time.perf_counter() - t0
            launches = tuple(k.launches for k in counted)
            n_caps, cap_sec = (x - y for x, y in zip(_captures(), caps))
        finally:
            VideoTransformer.logits_for_entire_video = inner_logits
            VideoTransformer.sample_video = inner_sample
        peak2 = torch.cuda.max_memory_allocated() - held
        vt_self, a, k = seen[0]  # one video's bits pass under torch.profiler, after the counts
        _, _, bits_wall, kern, _, _ = _profiled(lambda: inner_logits(vt_self, *a, **k))
        bits_busy = sum(us for _, us in kern) / 1e3
        del seen[:], vt_self, a, k
        bits = res2["likelihood"]["bits_per_dim"]
        fvd = res2["generation"]["FVD_stub"]
        check(launches == want, f"eval stage 2: launches of kernels 7, 1, 2 {launches}, want "
                                f"exactly {want}")
        check(n_caps == 1, f"eval stage 2: {n_caps} rollout graphs captured, want 1 for the run")
        check(0.0 < bits <= np.log2(512) + BITS_SLACK, f"eval stage 2: bits/dim {bits}")
        check(np.isfinite(fvd), f"eval stage 2: FVD_stub {fvd}")
        samples = os.path.join(vt_dir, "inference", "samples", "chip_smoke_eval_latents")
        for v in range(EVAL_VIDEOS):
            d = os.path.join(samples, f"video_0_{v}")
            names = sorted(os.listdir(d)) if os.path.isdir(d) else []
            check(names == sorted(["codes.npy"] + [f"{f}.png" for f in range(T_FRAMES)]),
                  f"eval stage 2: {d} holds {names}")
            codes = np.load(os.path.join(d, "codes.npy"))
            primed = np.stack([latents[f"video_{v}/{f}.npy"] for f in range(N_PRIME)], axis=1)
            check(codes.shape == (4, T_FRAMES, 16, 16) and 0 <= codes.min() and codes.max() < 512
                  and np.array_equal(codes[:, :N_PRIME], primed),
                  f"eval stage 2: video_0_{v}/codes.npy {codes.shape}, primed frames changed or "
                  "codes out of range")
        mib = 4 * 16 * 16 * 16 * 4 * 512 / 2 ** 20
        print(f"eval stage 2 DSFVT --eval-only BitsEvaluator,VTSampler,FVDEvaluator [{card}]: "
              f"{EVAL_VIDEOS} videos in {sec2:.2f} s with set-up; bits/dim {timed['bits']:.3f} s "
              f"(logits on the card; one video's pass profiled: device busy {bits_busy:.1f} ms "
              f"of {1e3 * bits_wall:.1f}) + {timed['host']:.3f} s moving {EVAL_VIDEOS} x "
              f"{mib:.0f} MiB of fp32 logits to the host; sampling {timed['sample']:.3f} s for "
              f"{EVAL_VIDEOS} rollouts of b=1 fp32, of it {cap_sec:.3f} s capturing {n_caps} "
              f"graph(s); max_memory_allocated {peak2 / 2 ** 20:.1f} MiB above what earlier "
              f"phases hold; launches of kernels 7, "
              f"1, 2 {launches} (want {want}); bits/dim {bits:.6f}, FVD_stub {fvd:.6g}")

        # ---- agreement, fp32: the card against the plain path on the CPU
        t0 = time.perf_counter()
        runs = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu")):
            out = os.path.join(tmp, f"vq_{name}")
            r = main(parse(stage1 + ["TEST.N_SAMPLES", "2", "MODEL.ENCODER.WEIGHTS", vq_dir,
                                     "OUTPUT_DIR", out]), device=device)
            runs[name] = (r["reconstruction"]["MSE"],
                          _latent_tree(os.path.join(out, "inference", "chip_smoke_eval_seq")))
        (m_card, l_card), (m_cpu, l_cpu) = runs["card"], runs["cpu"]
        check(set(l_card) == set(l_cpu) and len(l_cpu) == 2 * T_FRAMES,
              f"eval agree: latent files differ ({len(l_card)} vs {len(l_cpu)})")
        n_diff, n_far, total = _latent_near_ties(l_card, l_cpu, frames_root, vq_dir, vq_yaml)
        e_mse = abs(m_card - m_cpu) / abs(m_cpu)
        check(e_mse <= MSE_TOL, f"eval agree: MSE card {m_card} vs cpu {m_cpu}")
        check(_within_share(n_diff, n_far, total),
              f"eval agree: {n_diff} of {total} latent codes differ, {n_far} of them no near-tie")
        bits_runs = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu")):
            r = main(parse(stage2 + ["TEST.EVALUATORS", "BitsEvaluator", "TEST.N_SAMPLES", "1",
                                     "MODEL.GENERATOR.WEIGHTS", vt_dir,
                                     "OUTPUT_DIR", os.path.join(tmp, f"vt_{name}")]),
                     device=device)
            bits_runs[name] = r["likelihood"]["bits_per_dim"]
        e_bits = abs(bits_runs["card"] - bits_runs["cpu"])
        check(e_bits <= BITS_TOL, f"eval agree: bits/dim card {bits_runs['card']} vs cpu "
                                  f"{bits_runs['cpu']}")
        e_i3d, top, e_tf32, i3d_ms = _i3d_agree(card)
        check(e_i3d <= I3D_TOL * top, f"eval agree: i3d_apply card vs cpu {e_i3d} > "
                                      f"{I3D_TOL} x {top}")
        print(f"eval agree fp32 [{card}]: MSE over 2 videos card {m_card:.8g} vs cpu {m_cpu:.8g} "
              f"(rel {e_mse:.3g}, bound {MSE_TOL:g}); latents {n_diff} of {total} codes differ, "
              f"{n_far} no near-tie; bits/dim of 1 video card {bits_runs['card']:.8f} vs cpu "
              f"{bits_runs['cpu']:.8f} (|diff| {e_bits:.3g}, bound {BITS_TOL:g}); i3d_apply "
              f"(2, 16, 224, 224, 3) max_abs_err {e_i3d:.3g} of |logits| <= {top:.3g} (bound "
              f"{I3D_TOL:g} relative; TF32 on reads {e_tf32:.3g}), {i3d_ms:.3f} ms on the card; "
              f"{time.perf_counter() - t0:.1f} s")

        # ---- EvalHook: 4 fused DSFVT steps, TEST.EVAL_PERIOD 2
        hook_out = os.path.join(tmp, "hook")
        calls = []
        inner_run_test = defaults.run_test
        defaults.run_test = lambda *a, **k: calls.append(1) or inner_run_test(*a, **k)
        try:
            caps = _captures()
            t0 = time.perf_counter()
            tr = main(parse(["--config-file", vt_yaml, "DATASETS.TRAIN",
                             "('chip_smoke_eval_latents',)", "DATASETS.TEST",
                             "('chip_smoke_eval_latents',)", "TEST.EVAL_PERIOD", "2",
                             "TEST.EVALUATORS", "BitsEvaluator,VTSampler", "TEST.N_SAMPLES", "1",
                             "SOLVER.MAX_ITER", "4", "DATALOADER.NUM_WORKERS", "0", *paired,
                             "OUTPUT_DIR", hook_out]))
            torch.cuda.synchronize()
            sec_hook = time.perf_counter() - t0
            n_caps = _captures()[0] - caps[0]
        finally:
            defaults.run_test = inner_run_test
        check(tr.state.step == 4 and tr.model.fused, "eval hook: not 4 fused DSFVT steps")
        key = "eval/likelihood/bits_per_dim"
        stored = [v for v, _ in tr.storage.histories()[key].values()]
        del tr
        # metrics.json gets a row at the last step and after training (the
        # writer's period, 20, passes step 2 by): the final evaluation's value
        with open(os.path.join(hook_out, "metrics.json")) as f:
            logged = [r[key] for r in map(json.loads, f) if key in r]
        check(len(calls) == 2 and len(stored) == 2 and all(np.isfinite(stored))
              and logged and logged[-1] == stored[-1],
              f"eval hook: {len(calls)} evaluations, {key} stored {stored}, logged {logged}; "
              "want 2 evaluations, the last in metrics.json")
        check(n_caps == 2, f"eval hook: {n_caps} rollout graphs captured, want 2 (one an "
                           "evaluation: the optimizer changed the weights in place between)")
        print(f"eval hook DSFVT b=64, 4 fused steps, TEST.EVAL_PERIOD 2 [{card}]: "
              f"{len(calls)} evaluations (BitsEvaluator, VTSampler on 1 video), {key} "
              f"{stored} ({logged[-1]} in metrics.json), {n_caps} captures; "
              f"{sec_hook:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"nearest_indices": k6, "fused_layer_fwd": launches[0],
            "block_attention_fwd": launches[1], "decode_attention": launches[2]}


# phase 18: data parallel. Steps of each run (the last one profiled), global
# batches of DSFVT (videos) and PR-DVQVAE2 (frames), the most ranks NCCL
# takes (one per card), and the seconds a world may run before launch stops it
DP_STEPS, DP_VT_BATCH, DP_VQ_BATCH, DP_MAX_WORLD, DP_JOIN_TIMEOUT = 3, 16, 32, 4, 420


def _dp_runs():
    """Phase 18's runs: DSFVT at full width with the fused layer (kernels 7,
    8, 9) and PR-DVQVAE2 as it stands (EMA codebook, kernel 6), each with
    its global batches drawn from a numpy seed and a fixed SEED (the
    reference trainer must start from the same weights)."""
    import numpy as np

    rng = np.random.default_rng(18)
    vt = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    videos = [{"video": rng.integers(0, 512, (DP_VT_BATCH, 4, T_FRAMES, 16, 16))
               .astype(np.int32)} for _ in range(DP_STEPS)]
    return [
        {"name": "DSFVT", "config": vt, "opts": ["SEED", "7"], "unit": "videos",
         "frames_per_row": T_FRAMES, "batches": videos,
         "per_step": {"fused_layer_fwd": 16, "ffn_half_bwd": 16, "attn_half_bwd": 16}},
        {"name": "DSFVT unfused", "config": vt, "opts": ["SEED", "7", "TPU.FUSED_LAYER", "False"],
         "unit": "videos", "frames_per_row": T_FRAMES, "batches": videos,
         "per_step": {"block_attention_fwd": 32, "block_attention_bwd": 16}},
        {"name": "PR-DVQVAE2", "config": os.path.join(ROOT, "configs", "vqvae",
                                                      "PR-DVQVAE2.yaml"),
         "opts": ["SEED", "5"], "unit": "frames", "frames_per_row": 1,
         "per_step": {"nearest_indices": 1},
         "batches": [{"image": rng.uniform(0, 1, (DP_VQ_BATCH, 64, 64, 3)).astype(np.float32)}
                     for _ in range(DP_STEPS)]},
    ]


def _dp_wrappers():
    """The kernel wrappers of phase 18's runs, by their names in the kernels
    line."""
    from lvt_tpu_torch.ops.attention import block_attention_bwd_cuda, block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda
    from lvt_tpu_torch.ops.fused_layer import (attn_half_bwd_cuda, ffn_half_bwd_cuda,
                                               fused_layer_fwd_cuda)
    from lvt_tpu_torch.ops.vq import nearest_indices_grouped_cuda

    return {"fused_layer_fwd": fused_layer_fwd_cuda, "ffn_half_bwd": ffn_half_bwd_cuda,
            "attn_half_bwd": attn_half_bwd_cuda, "nearest_indices": nearest_indices_grouped_cuda,
            "block_attention_fwd": block_attention_fwd_cuda,
            "block_attention_bwd": block_attention_bwd_cuda,
            "decode_attention": decode_attention_cuda}


def _dp_generate(rank, world, device, wrappers):
    """Sharded greedy generation at full width (DSFVT in bf16, PR-DVQVAE2,
    seeded weights): one video a rank, each from the example frames rolled
    by 8 pixels a row, through generate_sharded (kernels 1 and 2 in the
    rollout's graph, per rank); on rank 0 every video again alone (b = 1),
    whose codes the gathered ones must equal bit for bit."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    models = gvt.build_models(gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")),
                              0, device, torch.bfloat16)
    frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"), N_PRIME))
    rows = torch.stack([frames.roll(8 * r, dims=2) for r in range(world)]).to(device)
    kernels = {k: wrappers[k] for k in ("block_attention_fwd", "decode_attention")}
    for k in kernels.values():
        k.launches = 0  # the counts cover the sharded rollout only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gvt.generate_sharded(*models, rows, N_PRIME, None, greedy=True)
    torch.cuda.synchronize()
    res = {"seconds": time.perf_counter() - t0,
           "launches": {n: k.launches for n, k in kernels.items()}}
    if out is not None:
        codes = out[1]
        res["shape"] = list(codes.shape)
        res["in_range"] = bool(codes.min() >= 0 and codes.max() < 512)
        res["equal"] = all(torch.equal(codes[r:r + 1], gvt.generate(
            *models, rows[r:r + 1], N_PRIME, None, greedy=True)[1].cpu()) for r in range(world))
    return res


def _rel_frobenius(got, ref):
    """(worst leaf, its name, whole) of ||got - ref|| / ||ref|| per leaf
    (Frobenius; the denominator floored at 1e-2 of the largest leaf norm)
    and over all leaves as one vector: the measure of GRAD_TOL."""
    import torch

    floor = 1e-2 * max(float(r.float().norm()) for r in ref.values())
    rel = {k: float((got[k].float() - r.float()).norm()) / max(float(r.float().norm()), floor)
           for k, r in ref.items()}
    k = max(rel, key=rel.get)
    whole = float(torch.stack([(got[n].float() - r.float()).norm() for n, r in ref.items()])
                  .norm()) / float(torch.stack([r.float().norm() for r in ref.values()]).norm())
    return rel[k], k, whole


def _dp_train(run, rank, world, device, kernels):
    """DP_STEPS steps of a Trainer of ``run`` on this rank's rows of the
    global batches, the last under torch.profiler. On rank 0 a one-process
    Trainer steps in lockstep on the whole batches: before each step it
    takes the data-parallel trainer's state (the synced scheme of the CPU
    tests), so that each step's averaged gradient, update and new model
    state are held to the whole batch's from the same state. Returns per
    step: synchronized seconds of the step and of its gradient average, a
    digest of params and model state after it and, on rank 0, the
    comparisons; with the kernel launches of the data-parallel run, the
    peak memory, the losses and the profile."""
    import copy
    import hashlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.engine.hooks import CallbackHook
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.models import tree_leaves
    from lvt_tpu_torch.ops import vq

    cfg = gvt.load_config(run["config"], run["opts"])
    field = next(iter(run["batches"][0]))
    n = len(run["batches"][0][field]) // world
    local = [{field: b[field][rank * n:(rank + 1) * n]} for b in run["batches"]]
    tr = Trainer(cfg, iter(local), device=device)
    ref = None
    if rank == 0:
        ref = Trainer(cfg, iter(()), device=device)
        ref.group = None  # the one-process trainer: its batch is the whole batch
    out = {"step_s": [], "avg_s": [], "digests": [], "cmp": []}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    grads, ref_launches = {}, [0] * len(kernels)

    def wrap_average(trainer, key):
        inner = trainer._average_grads

        def averaged():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner()
            torch.cuda.synchronize()
            if key == "dp":
                out["avg_s"].append(time.perf_counter() - t0)
            names = flatten(trainer.state.params)
            grads[key] = {k: m.grad.detach().clone()
                          for k, m in zip(names, tree_leaves(trainer.state.params))}
        trainer._average_grads = averaged

    def state_of(trainer):
        return ({k: v.detach().clone() for k, v in flatten(trainer.state.params).items()},
                {k: v.clone() for k, v in flatten(trainer.state.model_state).items()})

    def before(t):
        if ref is not None:
            out["tree"] = copy.deepcopy(t.checkpoint_tree())
            out["before"] = state_of(t)
        if t.iter == DP_STEPS - 1:
            prof.__enter__()
        torch.cuda.synchronize()
        out["t0"] = time.perf_counter()

    def after(t):
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - out["t0"])
        if t.iter == DP_STEPS - 1:
            prof.__exit__(None, None, None)
        h = hashlib.sha256()
        for v in list(flatten(t.state.params).values()) + list(
                flatten(t.state.model_state).values()):
            h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        out["digests"].append(h.hexdigest())
        if ref is None:
            return
        c0 = [k.launches for k in kernels]
        ref.load_tree(out.pop("tree"))
        dp_codes[:] = list(taken)
        taken.clear()
        metrics = ref.train_step(ref._put_batch(run["batches"][t.iter]))
        ref_codes = list(taken)
        for i, k in enumerate(kernels):
            ref_launches[i] += k.launches - c0[i]
        (p0, _), (p1, s1), (q1, r1) = out.pop("before"), state_of(t), state_of(ref)
        c = {"loss": float(sum(float(v) for v in metrics.values())),
             "grads": _rel_frobenius(grads["dp"], grads["ref"]),
             "grads_equal": all(torch.equal(grads["dp"][k], v) for k, v in grads["ref"].items()),
             "update": _rel_frobenius({k: p1[k].float() - p0[k].float() for k in p0},
                                      {k: q1[k].float() - p0[k].float() for k in p0}),
             "params": _rel_frobenius(p1, q1),
             "params_equal": all(torch.equal(p1[k], v) for k, v in q1.items()),
             "state": _rel_frobenius(s1, r1) if r1 else None,
             "state_equal": all(torch.equal(s1[k], v) for k, v in r1.items())}
        if dp_codes and ref_codes:  # this step's codes of rank 0's frames, near-tie rule
            (_, idx), (z, want) = dp_codes[-1], ref_codes[-1]
            rows = idx.shape[0]
            got, want = idx.reshape(-1, 4).cpu(), want[:rows].reshape(-1, 4).cpu()
            z = z[:rows].float().reshape(-1, 4, 64).cpu()
            emb = out["emb"]
            counts = [_indices_ok(got[:, g], want[:, g], z[:, g, :], emb[g]) for g in range(4)]
            c["indices"] = [sum(x[0] for x in counts), sum(x[1] for x in counts),
                            all(x[2] for x in counts), int(want.numel())]
        out["cmp"].append(c)

    wrap_average(tr, "dp")
    if ref is not None:
        wrap_average(ref, "ref")
    tr.register_hooks([CallbackHook(before_step=before, after_step=after)])
    inner_q, taken, dp_codes = vq.quantize_st, [], []

    def recording(z_e, codebook, *a, **k):
        res = inner_q(z_e, codebook, *a, **k)
        taken.append((z_e.detach(), res[2]))
        out["emb"] = codebook["embedding"].detach().cpu()  # the codebook the codes were found in
        return res

    vq.quantize_st = recording
    for k in kernels:
        k.launches = 0  # the counts cover this run only
    torch.cuda.reset_peak_memory_stats()
    try:
        tr.train(0, DP_STEPS)
    finally:
        vq.quantize_st = inner_q
    out["launches"] = [k.launches - r for k, r in zip(kernels, ref_launches)]
    out["peak"] = torch.cuda.max_memory_allocated()
    out["losses"] = [v for v, _ in tr.storage.history("total_loss").values()]
    ev = prof.key_averages()
    # self times: an op's device time also counts in the ops that call it
    device_ms = [getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                 for e in ev]
    out["profile"] = {
        "all_reduce_cpu_ms": sum(e.cpu_time_total for e in ev if "all_reduce" in e.key) / 1e3,
        "nccl_device_ms": sum(t for e, t in zip(ev, device_ms) if "nccl" in e.key.lower()) / 1e3,
        "device_ms": sum(device_ms) / 1e3}
    for k in ("emb", "t0"):
        out.pop(k, None)
    return out


def _dp_rank(spec, out_dir):
    """One rank of phase 18's world: each run data-parallel (with, on rank
    0, the one-process trainer in lockstep). Writes rank<r>.json into
    ``out_dir``."""
    import pickle

    import torch
    import torch.distributed as dist

    from lvt_tpu_torch.engine.defaults import rank_device
    from lvt_tpu_torch.utils import comm

    spec = pickle.loads(spec)
    rank, world = comm.get_rank(), comm.get_world_size()
    device = rank_device("cuda")
    wrappers = _dp_wrappers()
    res = {"rank": rank, "world": world, "backend": str(dist.get_backend()),
           "device": str(device), "runs": {}}
    for run in spec["runs"]:
        names = list(run["per_step"])
        out = _dp_train(run, rank, world, device, [wrappers[k] for k in names])
        out["launches"] = dict(zip(names, out["launches"]))
        res["runs"][run["name"]] = out
        torch.cuda.empty_cache()
    if world > 1:  # at one rank the sharded rollout is phase 4's
        res["generate"] = _dp_generate(rank, world, device, wrappers)
    if backend_is_gloo(res["backend"]) and world == TP_MODEL:
        res["tp"] = _tp_rank(rank, device)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def backend_is_gloo(name):
    return "gloo" in name.lower()


# phase 18's tensor-parallel world: the two gloo ranks on the card as data 1 x
# model TP_MODEL (TPU.MESH_MODEL 2). DSFVT unfused bf16 steps at global batch
# TP_VT_BATCH, PR-DVQVAE2 steps at TP_VQ_BATCH (phase 14's batch) with the
# codebook split over its codes, one fp32 greedy slice of the rollout at b =
# TP_SLICE_BATCH; launches per rank of each (kernels 1 and 10 per unfused step
# with per-layer remat: 32 and 16 on the rank's 4 heads; kernel 6 once a step on
# the rank's 256 codes a sub-codebook; the slice's encoder pass 8 of kernel 1,
# its 256 pixels x 8 layers of kernel 2)
TP_MODEL, TP_STEPS, TP_VT_BATCH, TP_VQ_BATCH, TP_SLICE_BATCH = 2, 2, 8, 32, 8
TP_PER_STEP = {"DSFVT": {"block_attention_fwd": 32, "block_attention_bwd": 16},
               "PR-DVQVAE2": {"nearest_indices": 1}}
TP_SLICE = {"block_attention_fwd": 8, "decode_attention": 256 * 8}
# The bf16 TP step's gradient against the one-process bf16 step's. The TP
# step rounds elsewhere (each rank's partial products of proj and FFN 2, and
# of the input gradient of the column-parallel products, are rounded to bf16
# before their sum), and a bf16 gradient of the VT is as far from another
# rounding of itself as from fp32: at a narrowed DSFVT on the CPU the TP step
# read 0.066-0.078 worst leaf and 0.043-0.045 whole, the one-process bf16 step
# against fp32 0.080 and 0.046. So the gradient rule (GRAD_TOL, with its TF32
# control) is held in fp32 (``_tp_agree``), and the bf16 step's distance is
# held within TP_OWN_ROUNDING times bf16's own rounding measured on the same
# state: a wrong sum over the group (a factor of 2, a missing part) reads
# ~1 and above.
TP_OWN_ROUNDING = 2.0


def _tp_timed_collectives():
    """Wrap the collectives of parallel/collectives.py with synchronized
    timers: returns (seconds list, undo)."""
    import torch

    from lvt_tpu_torch.parallel import collectives as col

    spent, inner = [], (col._all_reduce, col._all_gather)

    def timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out
        return run

    col._all_reduce, col._all_gather = timed(inner[0]), timed(inner[1])

    def undo():
        col._all_reduce, col._all_gather = inner
    return spent, undo


def _tp_train(rank, device, name, config, opts, batches, own_rounding=False):
    """TP_STEPS steps of a tensor-parallel Trainer (TPU.MESH_MODEL 2) of
    ``config`` on the whole global batches (one data index); on rank 0 a
    one-process Trainer from the same state (the synced scheme) on the same
    batch, whose gradient the TP step's gathered gradient is held to; with
    ``own_rounding`` also the one-process step in fp32 (TF32 off), whose
    distance from the one-process step is the compute dtype's own rounding.
    Returns per step: seconds, launches, the collectives' seconds (the last
    step, timed by synchronized wrappers), and on rank 0 the comparisons."""
    import copy

    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.ops import vq
    from lvt_tpu_torch.parallel import sharding

    cfg = gvt.load_config(config, opts + ["TPU.MESH_MODEL", str(TP_MODEL)])
    tr = Trainer(cfg, iter(()), device=device)
    ref = ref32 = None
    if rank == 0:
        ref = Trainer(gvt.load_config(config, opts), iter(()), device=device)
        ref.group = None  # the one-process trainer: its batch is the whole batch
        if own_rounding:
            ref32 = Trainer(gvt.load_config(config, opts + ["TPU.COMPUTE_DTYPE", "float32"]),
                            iter(()), device=device)
            ref32.group = None
    grads, taken = {}, []

    def capture(trainer, key, tp):
        inner = trainer._average_grads

        def averaged():
            inner()
            g = trainer.state.accum_grads()
            if tp:  # every rank gathers; the parts made whole
                g = sharding.gather_tree(g, trainer.model_group, trainer._tp.params)
            grads[key] = {k: v.float() for k, v in flatten(g).items()}
        trainer._average_grads = averaged

    capture(tr, "tp", True)
    if ref is not None:
        capture(ref, "ref", False)
    if ref32 is not None:
        capture(ref32, "ref32", False)
    inner_q = vq.quantize_st

    def recording(z_e, codebook, *a, **k):
        res = inner_q(z_e, codebook, *a, **k)
        taken.append((z_e.detach(), res[2]))
        return res
    out = {"step_s": [], "launches": [], "cmp": [], "collective_s": None, "peak": None}
    torch.cuda.reset_peak_memory_stats()
    vq.quantize_st = recording
    try:
        for i, batch in enumerate(batches):
            if i:  # the TP state made whole (every rank gathers); step 1's is every init's
                tree = tr.checkpoint_tree()
                for t in (ref, ref32):
                    if t is not None:
                        t.load_tree(copy.deepcopy(tree))
                del tree
            if ref is not None:  # the codebook the step's codes are found in
                emb = ref.state.model_state.get("netC", {}).get("embedding")
            spent, undo = _tp_timed_collectives() if i == len(batches) - 1 else (None, None)
            _zero_counts()
            taken.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                metrics = tr.train_step(tr._put_batch(batch))
                torch.cuda.synchronize()
            finally:
                if undo is not None:
                    undo()
            out["step_s"].append(time.perf_counter() - t0)
            out["launches"].append(_launched())
            if spent is not None:
                out["collective_s"] = [sum(spent), len(spent)]
            tp_codes = list(taken)
            if ref is None:
                continue
            c = {}
            forced = vq.nearest_indices_grouped
            if tp_codes and emb is not None:
                # the TP step's codes against the whole codebook's search on the
                # same z, by the near-tie rule; the one-process step then takes
                # the TP step's codes, so that a near-tie decided the other way
                # does not move its decoder's input (and gradient)
                (z, got) = tp_codes[-1]
                G = got.shape[-1]
                got = got.reshape(-1, G)
                z = z.reshape(got.shape[0], G, -1)
                want_idx = vq.nearest_indices_grouped(z, emb.to(z.device))
                counts = [_indices_ok(got[:, j].cpu(), want_idx[:, j].cpu(),
                                      z[:, j, :].float().cpu(), emb[j].cpu()) for j in range(G)]
                c["indices"] = [sum(x[0] for x in counts), sum(x[1] for x in counts),
                                all(x[2] for x in counts), int(got.numel())]
                vq.nearest_indices_grouped = lambda z_, cb, use_kernel=None: got
            try:
                want = ref.train_step(ref._put_batch(batch))
            finally:
                vq.nearest_indices_grouped = forced
            c.update(loss=[float(sum(float(v) for v in metrics.values())),
                           float(sum(float(v) for v in want.values()))],
                     grads=_rel_frobenius(grads["tp"], grads["ref"]))
            if ref32 is not None:
                ref32.train_step(ref32._put_batch(batch))
                c["own"] = _rel_frobenius(grads["ref"], grads["ref32"])
            out["cmp"].append(c)
        # after the last step: the params, made whole, against the one-process run's
        whole = flatten(tr.checkpoint_tree()["params"])
        if ref is not None:
            out["params"] = _rel_frobenius({k: v.float() for k, v in whole.items()},
                                           {k: v.float() for k, v in
                                            flatten(ref.state.params).items()})
        out["local_shapes"] = {k: list(v.shape) for k, v in flatten(tr.state.params).items()
                               if k.endswith(("layers.0.wq", "layers.0.ffn_w1", "netC.embedding",
                                              "ch_embed"))}
        out["local_shapes"].update({k: list(v.shape) for k, v in
                                    flatten(tr.state.model_state).items()
                                    if k.endswith("netC.embedding")})
    finally:
        vq.quantize_st = inner_q
    out["peak"] = torch.cuda.max_memory_allocated()
    del tr, ref, ref32
    torch.cuda.empty_cache()
    return out


def _tp_agree(rank, device):
    """One fp32 loss + backward of DSFVT at b = 2, unfused, tensor-parallel
    against the whole model on the same card and inputs (phase 8b's
    comparison), and on rank 0 the TF32 control: the whole model's gradient
    with TF32 allowed, which must read above the bounds. Returns on rank 0
    (tp vs whole, control vs whole) as ``_rel_frobenius`` gives them, and
    the losses."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group, tensor_parallel

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
                          ["TPU.FUSED_LAYER", "False", "TPU.MESH_MODEL", str(TP_MODEL)])
    vt = VideoTransformer(cfg)
    whole, _ = vt.init(torch.Generator().manual_seed(2))
    whole = to_device(whole, device)
    group = model_group(cfg)
    r, size = sharding.group_rank(group)
    dims = sharding.tp_dims(whole, size)
    video = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 4, T_FRAMES, 16, 16)))
    si = torch.tensor([1, 9])

    def grad(params, tp, tf32=False):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in flatten(params).items()}
        tree = _unflatten_like(params, p)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            with tensor_parallel(group if tp else None):
                loss, _ = vt.loss(tree, {"video": video.to(device)}, slice_idx=si)
                loss.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        g = _unflatten_like(params, {k: v.grad for k, v in p.items()})
        return float(loss.detach()), g

    loss_tp, g_tp = grad(sharding.shard_tree(whole, r, size, dims), True)
    g_tp = {k: v.float() for k, v in flatten(sharding.gather_tree(g_tp, group, dims)).items()}
    if rank != 0:
        return None
    loss_w, g_w = grad(whole, False)
    loss_c, g_c = grad(whole, False, tf32=True)
    g_w, g_c = ({k: v.float() for k, v in flatten(g).items()} for g in (g_w, g_c))
    return {"tp": _rel_frobenius(g_tp, g_w), "tf32": _rel_frobenius(g_c, g_w),
            "loss": [loss_tp, loss_w, loss_c]}


def _unflatten_like(tree, flat, prefix=""):
    """``flat`` ({dotted name: tensor}) in the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten_like(v, flat, f"{prefix}.{i}") for i, v in enumerate(tree)]
    return flat[prefix]


def _tp_slice(rank, device):
    """One fp32 greedy slice (slice N_PRIME, 256 pixels) of DSFVT's rollout at
    b = TP_SLICE_BATCH, tensor-parallel through ``sample_video``'s eager
    loop, and on rank 0 the same slice by the whole model (one rank). Where
    the codes differ, both models' teacher-forced logits on the TP codes
    tell whether each difference lies at a logit near-tie (the top two
    within twice their largest difference). Returns the seconds, the
    launches, and on rank 0 the comparison."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.models.vt import VideoTransformer, vt_encode
    from lvt_tpu_torch.models.vt_incremental import SliceDecoder
    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group, tensor_parallel

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
                          ["TPU.MESH_MODEL", str(TP_MODEL)])
    vt = VideoTransformer(cfg)
    whole, _ = vt.init(torch.Generator().manual_seed(3), device)
    group = model_group(cfg)
    part = sharding.shard_tree(whole, *sharding.group_rank(group))
    codes = torch.from_numpy(np.random.default_rng(19).integers(
        0, 512, (TP_SLICE_BATCH, 4, T_FRAMES, 16, 16))).to(device)
    c, plan, s = vt.c, vt.plan, N_PRIME
    primed = torch.zeros(plan.slice_src[s].size, dtype=torch.bool, device=device)

    def run(params, tp, teacher_of=None):
        with torch.no_grad(), tensor_parallel(group if tp else None):
            sidx = torch.full((TP_SLICE_BATCH,), s, dtype=torch.int64, device=device)
            ctx, sl, _ = vt.prepare_slices(codes, sidx)
            zl = vt_encode(params["netG"], c, ctx, sidx)
            dec = SliceDecoder(params["netG"], c, plan.slice_shape, TP_SLICE_BATCH, device)
            if teacher_of is not None:
                return dec.teacher(*dec.inputs(zl, teacher_of))
            return dec.run(zl, sl, primed, None, 1.0, True)

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(part, True)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "launches": _launched()}
    differ = None
    if rank == 0:
        t0 = time.perf_counter()
        want = run(whole, False)
        torch.cuda.synchronize()
        out["one_rank_seconds"] = time.perf_counter() - t0
        differ = int((got != want).sum())
    n = torch.tensor([-1 if differ is None else differ], dtype=torch.int64)
    torch.distributed.broadcast(n, 0, group=group)  # every rank takes the teacher pass, or none
    if int(n) > 0:
        lg_tp = run(part, True, teacher_of=got)
        if rank == 0:
            lg = run(whole, False, teacher_of=got)
            top2 = lg.topk(2, dim=-1)
            noise = float((lg_tp - lg).abs().max())
            flat_got = got.reshape(TP_SLICE_BATCH, 4, -1).movedim(1, -1)  # (b, thw, nc)
            flips = lg.argmax(-1) != flat_got
            gaps = (top2.values[..., 0] - top2.values[..., 1])[flips]
            out["teacher"] = {"noise": noise, "flips": int(flips.sum()),
                              "worst_gap": float(gaps.max()) if len(gaps) else 0.0,
                              "near_ties": bool((gaps <= 2 * noise).all())}
    if rank == 0:
        out["differ"] = differ
        out["total"] = int(got.numel())
        out["in_range"] = bool(got.min() >= 0 and got.max() < 512)
    return out


def _tp_rank(rank, device):
    """The tensor-parallel world's scenarios on this rank (phase 18)."""
    import numpy as np

    rng = np.random.default_rng(1918)
    vt = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    vq_cfg = os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml")
    videos = [{"video": rng.integers(0, 512, (TP_VT_BATCH, 4, T_FRAMES, 16, 16))
               .astype(np.int32)} for _ in range(TP_STEPS)]
    frames = [{"image": rng.uniform(0, 1, (TP_VQ_BATCH, 64, 64, 3)).astype(np.float32)}
              for _ in range(TP_STEPS)]
    res = {"DSFVT": _tp_train(rank, device, "DSFVT", vt,
                              ["SEED", "7", "TPU.FUSED_LAYER", "False",
                               "SOLVER.IMS_PER_BATCH", str(TP_VT_BATCH)], videos,
                              own_rounding=True),
           "PR-DVQVAE2": _tp_train(rank, device, "PR-DVQVAE2", vq_cfg,
                                   ["SEED", "5", "SOLVER.IMS_PER_BATCH", str(TP_VQ_BATCH)],
                                   frames),
           "agree": _tp_agree(rank, device),
           "slice": _tp_slice(rank, device)}
    return res


def _tp_checks(card, ranks):
    """Phase 18's tensor-parallel world held: exact launches per rank, the
    split leaves' shapes, on rank 0 the gradients, params, losses and codes
    against the one-process runs, the fp32 agreement and its TF32 control,
    the slice's codes. Returns {kernel: [launches of rank 0, rank 1]}."""
    import numpy as np

    counts = {}
    for rk in ranks:
        tp = rk["tp"]
        for name in ("DSFVT", "PR-DVQVAE2"):
            r = tp[name]
            for i, got in enumerate(r["launches"]):
                check(got == TP_PER_STEP[name], f"tp {name} rank {rk['rank']} step {i + 1}: "
                                                f"launches {got}, want {TP_PER_STEP[name]}")
            for k, n in TP_PER_STEP[name].items():
                counts.setdefault(k, [0] * len(ranks))[rk["rank"]] += n * len(r["launches"])
            coll, n_coll = r["collective_s"]
            steps = ", ".join(f"{t:.4f}" for t in r["step_s"])
            print(f"  tensor parallel {name} rank {rk['rank']} (data 1 x model {TP_MODEL}, gloo, "
                  f"on {rk['device']}) [{card}]: steps {steps} "
                  f"s (synchronized); the last step's {n_coll} collectives "
                  f"{coll:.4f} s = {100 * coll / r['step_s'][-1]:.1f}% of it (each synchronized "
                  f"and timed); launches per step {r['launches'][-1]}; max_memory_allocated "
                  f"{r['peak'] / 2 ** 30:.2f} GiB; the rank's parts "
                  f"{json.dumps(r['local_shapes'])}")
        shapes = tp["DSFVT"]["local_shapes"]
        check(shapes.get("netG.decoder.layers.0.wq") == [4, 512, 128]
              and shapes.get("netG.decoder.layers.0.ffn_w1") == [512, 256]
              and tp["PR-DVQVAE2"]["local_shapes"].get("netC.embedding") == [4, 256, 64],
              f"tp rank {rk['rank']}: the split leaves' shapes {shapes}, "
              f"{tp['PR-DVQVAE2']['local_shapes']}")
        sl = tp["slice"]
        check(sl["launches"] == TP_SLICE, f"tp slice rank {rk['rank']}: launches "
                                          f"{sl['launches']}, want {TP_SLICE}")
        for k, n in TP_SLICE.items():
            counts.setdefault(k, [0] * len(ranks))[rk["rank"]] += n
    tp = ranks[0]["tp"]
    for name in ("DSFVT", "PR-DVQVAE2"):
        r = tp[name]
        for i, c in enumerate(r["cmp"]):
            (e, k, w) = c["grads"]
            line = (f"  tensor parallel {name} step {i + 1} vs one process from the same state "
                    f"[{card}]: loss {c['loss'][0]:.6f}/{c['loss'][1]:.6f}; gathered gradient, "
                    f"relative Frobenius worst leaf {e:.3g} ({k}), whole {w:.3g} (bounds "
                    f"{GRAD_TOL:g}, {GRAD_TOL_WHOLE:g})")
            if "indices" in c:
                line += (f"; codes {c['indices'][0]} of {c['indices'][3]} differ "
                         f"({c['indices'][1]} no near-tie)")
            if "own" in c:
                line += (f"; bf16's own rounding (the one-process bf16 step against its fp32 "
                         f"step) {c['own'][0]:.3g} ({c['own'][1]}), whole {c['own'][2]:.3g}")
            print(line)
            if "own" in c:  # see TP_OWN_ROUNDING
                check(e <= TP_OWN_ROUNDING * c["own"][0] and w <= TP_OWN_ROUNDING * c["own"][2],
                      f"tp {name} step {i + 1}: gradient off by {e} ({k}), whole {w}, beyond "
                      f"{TP_OWN_ROUNDING} x bf16's own rounding {c['own']}")
            else:
                check(e <= GRAD_TOL and w <= GRAD_TOL_WHOLE,
                      f"tp {name} step {i + 1}: gradient off by {e} ({k}), whole {w}")
            check(abs(c["loss"][0] - c["loss"][1]) <= 1e-3 * abs(c["loss"][1]),
                  f"tp {name} step {i + 1}: loss {c['loss']}")
            if "indices" in c:
                check(c["indices"][2], f"tp {name} step {i + 1}: codes {c['indices']}")
        e, k, w = r["params"]
        print(f"  tensor parallel {name}: params after step {len(r['cmp'])} vs one process, "
              f"worst leaf {e:.3g} ({k}), whole {w:.3g}")
        check(e <= GRAD_TOL and w <= GRAD_TOL_WHOLE, f"tp {name}: params off by {r['params']}")
    a = tp["agree"]
    (e, k, w), (e_c, k_c, w_c) = a["tp"], a["tf32"]
    print(f"  tensor parallel fp32 agreement, DSFVT b=2 one loss+backward [{card}]: TP vs the "
          f"whole model worst leaf {e:.3g} ({k}), whole {w:.3g}; TF32 control {e_c:.3g} ({k_c}), "
          f"{w_c:.3g}; losses TP/whole/TF32 {', '.join(f'{x:.6f}' for x in a['loss'])}")
    check(e <= GRAD_TOL and w <= GRAD_TOL_WHOLE, f"tp agree: gradient off by {e} ({k}), {w}")
    check(e_c > GRAD_TOL and w_c > GRAD_TOL_WHOLE,
          f"tp agree: the TF32 control reads {e_c}, {w_c}, within the bounds")
    sl = tp["slice"]
    teach = sl.get("teacher")
    print(f"  tensor parallel fp32 greedy slice, b={TP_SLICE_BATCH} [{card}]: "
          f"{max(r['tp']['slice']['seconds'] for r in ranks):.2f} s (eager, the slowest rank; "
          f"one rank {sl['one_rank_seconds']:.2f} s); {sl['differ']} of {sl['total']} codes "
          f"differ from the one-rank slice's"
          + (f"; teacher-forced on the TP codes, {teach['flips']} argmax flips, largest top-2 gap "
             f"among them {teach['worst_gap']:.3g}, |TP - one rank| logits <= "
             f"{teach['noise']:.3g}" if teach else ""))
    check(sl["in_range"] and (sl["differ"] == 0 or (teach and teach["near_ties"])),
          f"tp slice: {sl}")
    return {k: v for k, v in counts.items() if np.sum(v)}


def phase_data_parallel(card):
    """(a) Two ranks on the card over gloo, (b) NCCL at one rank per card (up
    to DP_MAX_WORLD), each through engine.launch: every run of _dp_runs held
    on rank 0 to the one-process Trainer from the same state on the same
    global batch (world 1 under NCCL: bit-equal), the ranks' params and
    model state bit-equal after every step, exact launches per rank; then
    sharded greedy generation equal to each video generated alone. Returns
    {world: {kernel: [launches of rank 0, rank 1, ...]}}."""
    import datetime
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lvt_tpu_torch.engine.launch import launch

    runs = _dp_runs()
    spec = pickle.dumps({"runs": runs})
    worlds = [("gloo", 2), ("nccl", min(torch.cuda.device_count(), DP_MAX_WORLD))]
    print(f"data parallel: worlds {worlds} (backend, ranks); {DP_STEPS} steps a run, the last "
          f"profiled; DSFVT global batch {DP_VT_BATCH} videos (fused and unfused), PR-DVQVAE2 "
          f"{DP_VQ_BATCH} frames; then one greedy video a rank")
    launches = {}
    for backend, world in worlds:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
        try:
            t0 = time.perf_counter()
            launch(_dp_rank, world, backend=backend, args=(spec, tmp),
                   timeout=datetime.timedelta(seconds=DP_JOIN_TIMEOUT),
                   join_timeout=DP_JOIN_TIMEOUT)
            wall = time.perf_counter() - t0
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"data parallel {backend} world {world} [{card}]: {wall:.1f} s with the spawn")
        counts = launches.setdefault(f"{backend}{world}", {})
        exact = backend == "nccl" and world == 1
        for run in runs:
            name, batch = run["name"], len(run["batches"][0][next(iter(run["batches"][0]))])
            per = [rk["runs"][name] for rk in ranks]
            for rk, r in zip(ranks, per):
                check(rk["world"] == world and rk["backend"] == backend,
                      f"dp {name}: rank {rk['rank']} in a world of {rk['world']} over "
                      f"{rk['backend']}")
                sec = float(np.median(r["step_s"][1:-1]))
                share = float(np.median([a / t for a, t in zip(r["avg_s"][1:-1],
                                                               r["step_s"][1:-1])]))
                prof = r["profile"]
                print(f"  {name} rank {rk['rank']} {backend} world {world} on {rk['device']}: "
                      f"{sec:.4f} s/step (median of steps 2-{DP_STEPS - 1}, synchronized), "
                      f"global batch {batch}: {batch / sec:.2f} {run['unit']}/s, "
                      f"{batch * run['frames_per_row'] / sec:.1f} frames/s; gradient average "
                      f"{100 * share:.1f}% of the step (synchronized); profiled step "
                      f"{r['step_s'][-1]:.4f} s: all_reduce {prof['all_reduce_cpu_ms']:.2f} ms on "
                      f"the host, NCCL kernels {prof['nccl_device_ms']:.2f} ms, device busy "
                      f"{prof['device_ms']:.2f} ms; max_memory_allocated "
                      f"{r['peak'] / 2 ** 30:.2f} GiB; launches {r['launches']}")
                for k, n in r["launches"].items():
                    want = DP_STEPS * run["per_step"][k]
                    check(n == want, f"dp {name} rank {rk['rank']}: {n} launches of {k}, want "
                                     f"{want}")
                    counts.setdefault(k, [0] * world)[rk["rank"]] += n
            for i in range(DP_STEPS):
                check(len({r["digests"][i] for r in per}) == 1,
                      f"dp {name} {backend}: the ranks' params differ after step {i + 1}")
            cmp = per[0]["cmp"]
            check(len(cmp) == DP_STEPS, f"dp {name} {backend}: {len(cmp)} steps compared")
            for i, c in enumerate(cmp):
                (e, k, w), (e_p, k_p, w_p), (e_u, k_u, w_u) = c["grads"], c["params"], c["update"]
                line = (f"  {name} {backend} world {world}, step {i + 1} vs one process from "
                        f"the same state [{card}]: loss {per[0]['losses'][i]:.6f}/"
                        f"{c['loss']:.6f}; relative Frobenius, worst leaf and whole: averaged "
                        f"gradient {e:.3g} ({k}), {w:.3g}; params {e_p:.3g} ({k_p}), {w_p:.3g}; "
                        f"the step's update {e_u:.3g} ({k_u}), {w_u:.3g} (printed, not held)")
                if c["state"] is not None:
                    line += (f"; model state {c['state'][0]:.3g} ({c['state'][1]}), "
                             f"{c['state'][2]:.3g}")
                if "indices" in c:
                    line += (f"; codes of rank 0's frames: {c['indices'][0]} of "
                             f"{c['indices'][3]} differ ({c['indices'][1]} no near-tie)")
                bit_equal = c["grads_equal"] and c["params_equal"] and c["state_equal"]
                print(line + (f"; bit-equal {bit_equal}" if exact else ""))
                if exact:
                    check(bit_equal and per[0]["losses"][i] == c["loss"],
                          f"dp {name} step {i + 1}: one NCCL rank is not bit-equal to the "
                          f"one-process trainer (gradient {c['grads_equal']}, params "
                          f"{c['params_equal']}, model state {c['state_equal']}, loss "
                          f"{per[0]['losses'][i]} vs {c['loss']})")
                    continue
                check(e <= GRAD_TOL and w <= GRAD_TOL_WHOLE,
                      f"dp {name} {backend} step {i + 1}: averaged gradient off by {e} ({k}), "
                      f"whole {w}")
                # the update itself is not held: RMSprop's and Adam's first steps are
                # sign-like (lr g / |g|), so an element whose gradient sits at fp32/bf16
                # noise steps either way in the two runs (DSFVT's dt_bank, biases)
                check(e_p <= GRAD_TOL and w_p <= GRAD_TOL_WHOLE,
                      f"dp {name} {backend} step {i + 1}: params off by {e_p} ({k_p}), "
                      f"whole {w_p}")
                if c["state"] is not None:
                    check(c["state"][0] <= GRAD_TOL and c["state"][2] <= GRAD_TOL_WHOLE,
                          f"dp {name} {backend} step {i + 1}: model state off by {c['state']}")
                if "indices" in c:
                    check(c["indices"][2], f"dp {name} {backend} step {i + 1}: codes "
                                           f"{c['indices']}")
                check(abs(per[0]["losses"][i] - c["loss"]) <= 1e-3 * abs(c["loss"]),
                      f"dp {name} {backend} step {i + 1}: loss {per[0]['losses'][i]}, one "
                      f"process {c['loss']}")
        if world == 1:
            continue
        if "tp" in ranks[0]:
            launches["tp"] = _tp_checks(card, ranks)
        gens = [rk["generate"] for rk in ranks]
        per_rollout = {"block_attention_fwd": (T_FRAMES - N_PRIME) * 8,
                       "decode_attention": (T_FRAMES - N_PRIME) * 256 * 8}
        for rk, g in zip(ranks, gens):
            check(g["launches"] == per_rollout, f"dp generation rank {rk['rank']}: launches "
                                                f"{g['launches']}, want {per_rollout}")
            for k, n in g["launches"].items():
                counts.setdefault(k, [0] * world)[rk["rank"]] += n
        g0 = gens[0]
        print(f"  sharded generation {backend} world {world} [{card}]: one greedy bf16 video a "
              f"rank in {max(g['seconds'] for g in gens):.2f} s (the slowest rank, the graph's "
              f"capture included); codes {g0['shape']}, each video's equal to it generated "
              f"alone: {g0['equal']}; launches per rank {g0['launches']}")
        check(g0["shape"] == [world, 4, T_FRAMES, 16, 16] and g0["in_range"] and g0["equal"],
              f"dp generation {backend}: {g0}")
    return launches


# phase 19: the e2e chain of tools/e2e_demo_torch.py at its defaults
E2E_ITERS = 30  # the tool's --iters1 and --iters2 (its defaults are 300: cut for the time limit)
E2E_VIDEOS = {"bair": 64, "class-conditional": 66}  # the tool's sets: 64 videos; 3 x 22
E2E_BITS_VIDEOS = 4  # the tool's TEST.N_SAMPLES for bits/dim
E2E_PIPE_STEPS = 100  # steps of each bench_pipeline_torch trainer run (native, PIL)
KINETICS_FRAMES = 64  # seeded 240 x 320 frames of the converter's video: one device chunk
# converted frames against the reference's per-frame PIL recipe. PIL filters
# in fixed point and clips its uint8 intermediate between the two passes;
# on uniform noise the Lanczos ringing overshoots [0, 255] there, and a few
# pixels land several steps from the float filter: on these frames 11 of
# 786,432 pixels lie 2 to 5 steps away, and lvt_tpu's device path reads the
# same (scripts/convert_kinetics.py). So: at most 1 pixel in 10,000 beyond
# one step, none beyond tests/test_preprocess.py's bound of 12.
PIL_MAX_STEPS, PIL_BEYOND_SHARE = 12, 1e-4
# whether encode_indices (code extraction, generation) takes kernel 6 on a CUDA
# tensor: decided by this phase's count on the trained codebook (ops/vq.py)
ENCODE_KERNEL6 = True


def _e2e_expected(mode):
    """The launches of each kernel (by its name in the kernels line) in each
    stage of tools/e2e_demo_torch.py at its defaults, stated before the run:
    kernel 6 once a VQ-VAE step (and once a test video where encode_indices
    takes it) plus the check's own calls, one per 256 frames; kernels 7, 8
    and 9 16 times a fused VT step; kernel 7 256 times a video of bits/dim
    (16 slices x 16 layers, fp32); 88 of kernel 1 and 22,528 of kernel 2 a
    rollout."""
    n = E2E_VIDEOS[mode]
    rollout = {"block_attention_fwd": (T_FRAMES - N_PRIME) * 8,
               "decode_attention": (T_FRAMES - N_PRIME) * 256 * 8}
    want = {"dataset": {}, "vqvae_train": {"nearest_indices": E2E_ITERS},
            "vqvae_eval": {"nearest_indices": n} if ENCODE_KERNEL6 else {},
            "kernel6_check": {"nearest_indices": -(-n * T_FRAMES // 256)},
            "vt_train": {k: 16 * E2E_ITERS for k in ("fused_layer_fwd", "ffn_half_bwd",
                                                     "attn_half_bwd")},
            "bits": {"fused_layer_fwd": 256 * E2E_BITS_VIDEOS},
            "rollout": rollout, "decode": {}}
    if mode == "class-conditional":
        want["rollout_alt_class"] = rollout
    return want


def _e2e_run(card, workdir, mode):
    """tools/e2e_demo_torch.py's main in one mode at its defaults (full
    width) but E2E_ITERS + E2E_ITERS steps, every count set to 0 just before and read just
    after; each stage's launches held to _e2e_expected. Returns (the tool's
    result, {kernel: launches of the run, the kernel-6 check's apart})."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import e2e_demo_torch
    from lvt_tpu_torch.ops._lib import COUNTED

    wrappers = _dp_wrappers()
    names = {w.__name__: n for n, w in wrappers.items()}
    argv = ["--workdir", os.path.join(workdir, mode), "--iters1", str(E2E_ITERS),
            "--iters2", str(E2E_ITERS)]
    if mode == "class-conditional":
        argv.append("--class-conditional")
    for f in COUNTED:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = e2e_demo_torch.main(argv)
    wall = time.perf_counter() - t0
    total = {n: w.launches for n, w in wrappers.items() if w.launches}
    others = [f.__name__ for f in COUNTED if f.launches and f.__name__ not in names]
    peak = torch.cuda.max_memory_allocated()
    got = {stage: {names.get(k, k): v for k, v in counts.items()}
           for stage, counts in res["launches"].items()}
    want = _e2e_expected(mode)
    check(got == want, f"e2e {mode}: launches by stage {got}, want {want}")
    check(not others, f"e2e {mode}: launches of {others}")
    check_launches = got["kernel6_check"]["nearest_indices"]
    main_path = dict(total, nearest_indices=total["nearest_indices"] - check_launches)

    codes, frames = res["codes"], res["frames"]
    check(tuple(codes.shape) == (1, 4, T_FRAMES, 16, 16) and int(codes.min()) >= 0
          and int(codes.max()) < 512, f"e2e {mode}: codes {tuple(codes.shape)} in "
                                      f"[{int(codes.min())}, {int(codes.max())}]")
    check(tuple(frames.shape) == (T_FRAMES, 64, 64, 3) and bool(torch.isfinite(frames).all())
          and float(frames.min()) >= 0.0 and float(frames.max()) <= 255.0,
          f"e2e {mode}: decoded frames {tuple(frames.shape)} not finite in [0, 255]")
    check(sorted(os.listdir(res["generated_dir"])) == sorted(f"{i}.png" for i in range(T_FRAMES)),
          f"e2e {mode}: PNGs {os.listdir(res['generated_dir'])}")
    for key in ("loss_reconstruction", "loss_cross_entropy"):
        check(all(np.isfinite(res[key])), f"e2e {mode}: {key} {res[key]}")
    check(np.isfinite(res["mse"]) and np.isfinite(res["bits_per_dim"]),
          f"e2e {mode}: MSE {res['mse']}, bits/dim {res['bits_per_dim']}")
    if mode == "class-conditional":
        check(res["class_codes_differ"] > 0, "e2e: the class made no difference to the rollout")
    k6 = res["kernel6"]
    share = k6["differ"] / k6["indices"]
    near_ties_only = _within_share(k6["differ"], k6["far"], k6["indices"])
    check(k6["kernel"] and k6["far"] == 0,
          f"e2e {mode}: kernel 6 on the trained codebook: {k6['far']} of {k6['differ']} "
          "differing indices are no near-tie")
    sec = res["seconds"]
    print(f"e2e {mode} [{card}]: {wall:.1f} s, by stage " +
          ", ".join(f"{k} {v:.2f}" for k, v in sec.items()) +
          f" s; VQ-VAE loss_reconstruction {res['loss_reconstruction'][0]:.4f} -> "
          f"{res['loss_reconstruction'][1]:.4f} (median of the last 20), VT loss_cross_entropy "
          f"{res['loss_cross_entropy'][0]:.4f} -> {res['loss_cross_entropy'][1]:.4f}; MSE "
          f"{res['mse']:.6f}, bits/dim {res['bits_per_dim']:.4f}; VQ-VAE data_time median "
          f"{res['data_time'] * 1e3:.3f} ms; max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    print(f"  launches by stage {got}")
    print(f"  kernel 6 on the trained codebook: {k6['differ']} of {k6['indices']} indices "
          f"({share:.2e}) differ from the plain fp32 search, {k6['far']} of them no float64 "
          f"near-tie: {'every difference a near-tie within the share' if near_ties_only else 'NOT within the near-tie rule'}"
          f" (encode_indices on the card takes {'kernel 6' if ENCODE_KERNEL6 else 'the plain version'})")
    if mode == "class-conditional":
        print(f"  the same priming and generator with another class: {res['class_codes_differ']} "
              f"of {codes.numel()} codes differ")
    return res, main_path


def _e2e_kinetics(card, tmp):
    """convert_kinetics_torch.process_video --preprocess device on
    KINETICS_FRAMES seeded 240 x 320 frames, ffmpeg stubbed: the frames are
    center_crop_resize's on the card, held to the reference's PIL recipe
    (PIL_MAX_STEPS, PIL_BEYOND_SHARE); center_crop_resize on the card against
    the CPU on the same chunk; its device time against the per-frame PIL
    loop's host time."""
    import numpy as np
    import torch
    from PIL import Image

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import convert_kinetics_torch as ck
    from lvt_tpu_torch.data.preprocess import center_crop_resize

    rng = np.random.default_rng(19)
    frames = rng.integers(0, 256, (KINETICS_FRAMES, 240, 320, 3), dtype=np.uint8)

    def fake_ffmpeg(cmd, shell=None, stderr=None):  # "extracts" the frames into save_dir
        save_dir = os.path.dirname(cmd.split('"')[3])
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(save_dir, f"{i + 1}.png"))
        return b""

    def pil(f):
        img = Image.fromarray(f)
        left, top = (320 - 240) / 2, 0
        return np.asarray(img.crop((left, top, left + 240, top + 240))
                          .resize((64, 64), Image.LANCZOS))

    video = os.path.join(tmp, "kinetics", "archery", "vid.mp4")
    os.makedirs(os.path.dirname(video))
    open(video, "wb").close()
    out = os.path.join(tmp, "kinetics_out")
    saved, ck.subprocess.check_output = ck.subprocess.check_output, fake_ffmpeg
    try:
        t0 = time.perf_counter()
        n = ck.process_video(video, out, 64, preprocess="device")
        sec = time.perf_counter() - t0
    finally:
        ck.subprocess.check_output = saved
    check(n == KINETICS_FRAMES, f"kinetics: {n} frames converted")
    t0 = time.perf_counter()
    ref = np.stack([pil(f) for f in frames]).astype(np.int32)
    pil_ms = (time.perf_counter() - t0) * 1e3
    got = np.stack([np.asarray(Image.open(os.path.join(out, "archery", "vid", f"{i + 1}.png")))
                    for i in range(KINETICS_FRAMES)]).astype(np.int32)
    diff = np.abs(got - ref)
    beyond = float((diff > 1).mean())
    check(got.shape == (KINETICS_FRAMES, 64, 64, 3) and diff.max() <= PIL_MAX_STEPS
          and beyond <= PIL_BEYOND_SHARE,
          f"kinetics: converted frames {got.shape}, {diff.max()} steps from PIL, "
          f"{beyond:.2e} of pixels beyond one step")

    x = torch.from_numpy(frames).cuda()
    card_out = center_crop_resize(x, 64).cpu().numpy().astype(np.int32)
    check(np.array_equal(card_out, got), "kinetics: process_video's frames are not "
                                         "center_crop_resize's on the card")
    cpu_out = center_crop_resize(torch.from_numpy(frames), 64).numpy().astype(np.int32)
    d = np.abs(card_out - cpu_out)
    check(d.max() <= 1 and (d > 0).mean() <= 1e-3,
          f"center_crop_resize: card vs CPU {d.max()} steps, {(d > 0).mean():.2e} of pixels")
    ms = device_ms([lambda: center_crop_resize(x, 64)], 20)
    nbytes = x.numel() + KINETICS_FRAMES * 64 * 64 * 3
    flops = 2 * KINETICS_FRAMES * 3 * (64 * 240 * 240 + 64 * 64 * 240)
    bound, by = bound_ms("float32", nbytes, flops)
    print(f"kinetics [{card}]: process_video --preprocess device, {KINETICS_FRAMES} frames of "
          f"240x320 -> 64x64 in {sec:.2f} s (stubbed ffmpeg, PNG reads and writes included); "
          f"against PIL: {(diff > 0).mean():.2e} of pixels differ, {beyond:.2e} by more than "
          f"one step, at most {diff.max()}; "
          f"center_crop_resize on the chunk: card {ms:.4f} ms (device, CUDA graph replay), "
          f"bound {bound:.4f} ms ({by}), the per-frame PIL loop {pil_ms:.2f} ms on the host; "
          f"card vs CPU {d.max()} step, {(d > 0).mean():.2e} of pixels")
    return {"ms": ms, "pil_ms": pil_ms, "bound_ms": bound}


def _e2e_img_size(card, tmp):
    """scripts/generate_videos_torch.py --img-size 64 on N_PRIME seeded 96 x 128
    priming frames, at full width with random weights: codes in range, frames
    finite in [0, 255], exactly 88 launches of kernel 1 and 22,528 of kernel 2."""
    import numpy as np
    from PIL import Image

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    rng = np.random.default_rng(20)
    prime = os.path.join(tmp, "prime_96x128")
    os.makedirs(prime)
    for i in range(N_PRIME):
        Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(
            os.path.join(prime, f"{i}.png"))
    argv = ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
            "--video-dir", prime, "--img-size", "64", *NO_VQ_WEIGHTS,
            "OUTPUT_DIR", os.path.join(tmp, "generated_img_size")]
    _reset_counts()
    video, codes, primed, seconds = gvt.main(argv)
    launches = _counts()
    _check_run("generate --img-size 64", video, codes, primed, 512, 1)
    want = ((T_FRAMES - N_PRIME) * 8, (T_FRAMES - N_PRIME) * 256 * 8)
    check(launches == want, f"generate --img-size: launches of kernels 1, 2 {launches}, want "
                            f"{want}")
    print(f"generate --img-size 64 [{card}]: 5 priming frames of 96x128 cropped and resized on "
          f"the card, codes {tuple(codes.shape)}, rollout {seconds:.2f} s (the capture "
          f"included); launches of kernels 1, 2 {launches}")
    return dict(zip(("block_attention_fwd", "decode_attention"), launches))


def phase_e2e(card):
    """Phase 19: the e2e chain in both modes at full width, the Kinetics
    converter on the card, generation with --img-size, the native IO library
    and the loader's data_time with it against PIL. Returns {run: {kernel:
    launches}}."""
    import shutil
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_pipeline_torch as bp
    from lvt_tpu_torch import native
    from lvt_tpu_torch.utils.image import get_image_paths, read_image

    check(native.available(), "native lvt_io did not build or load (g++ and zlib)")
    print(f"native lvt_io: loaded from {os.path.relpath(native.LIBRARY.path, ROOT)}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    launches = {}
    try:
        for mode in ("bair", "class-conditional"):
            _, launches[mode] = _e2e_run(card, tmp, mode)
        _e2e_kinetics(card, tmp)
        launches["generate --img-size"] = _e2e_img_size(card, tmp)

        # data_time: PR-DVQVAE2 as it stands over the BAIR run's frames
        bench = os.path.join(tmp, "bench")
        os.makedirs(bench)
        os.symlink(os.path.join(tmp, "bair", "videos"), os.path.join(bench, "frames"))
        cfg = bp.build_cfg("vqvae", bench)
        rates = bp.both(bp.measure_e2e, cfg, "vqvae", E2E_PIPE_STEPS, torch.device("cuda"))
        for kind, r in rates.items():
            print(f"pipeline PR-DVQVAE2 b={r['batch']} workers {r['workers']} [{card}], {kind} "
                  f"reader: {r['sec_per_iter']:.5f} s/iteration ({r['items_per_sec']:.1f} "
                  f"frames/s) over {r['steps']} steps, the step alone "
                  f"{r['device_only_sec_per_iter']:.5f} s; data_time mean "
                  f"{r['data_time_mean_ms']:.3f} ms, max {r['data_time_max_ms']:.3f} ms")
        # the same frames through the loader alone, and through each decoder alone
        rates = bp.both(bp.measure_loader, cfg, "vqvae", 50)
        paths = [d["image_path"] for d in get_image_paths(os.path.join(bench, "frames"),
                                                          use_cache=False)]
        decode = {}
        for kind, read in (("native", native.read_png_rgb),
                           ("pil", lambda p: read_image(p, "RGB"))):
            t0 = time.perf_counter()
            for path in paths:
                read(path)
            decode[kind] = (time.perf_counter() - t0) / len(paths) * 1e3
        print(f"loader PR-DVQVAE2 b={cfg.SOLVER.IMS_PER_BATCH} workers "
              f"{cfg.DATALOADER.NUM_WORKERS}, no card in the loop: native "
              f"{rates['native']['items_per_sec']:.1f} frames/s, PIL "
              f"{rates['pil']['items_per_sec']:.1f}; one 64x64 PNG decoded on the host: "
              f"native {decode['native']:.4f} ms, PIL {decode['pil']:.4f} ms ({len(paths)} "
              f"frames)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches



# --------------------------------------------------------------------------
# phase 20: the other shipped geometries at full width
# --------------------------------------------------------------------------

GEO_B, GEO_ITERS, GEO_TRAIN_STEPS = 8, 1, 8  # rollout batch, timed calls after the first; steps
# bench_sample_torch options of each rollout: native, and one int8 mode a geometry
GEO_ROLLOUTS = (
    ("DSSVT", "native", ()),
    ("DSSVT", "int8 KV + pallas + int8-pallas weights",
     ("--kv", "int8", "--attn", "pallas", "--weights", "int8-pallas")),
    ("DSTSVT", "native", ()),
    ("DSTSVT", "int8 KV + pallas-live", ("--kv", "int8", "--attn", "pallas-live")),
)
# (slices, pixels a slice) of a 16 x 16 x 16 video. Primed with 5 frames, every
# DSSVT slice (16 x 8 x 8) and every DSTSVT slice (4 x 8 x 8) holds primed and
# unprimed positions, so all are sampled
GEO_SLICES = {"DSFVT": (16, 256), "DSSVT": (4, 1024), "DSTSVT": (16, 256)}
GEO_EXACT_TOL = 2e-4  # logits_for_entire_video_incremental vs logits_for_entire_video, rtol = atol


def _geo_rollout_expected(name, label):
    """Launches of one rollout (b = 8, every slice sampled, 8 + 8 layers),
    stated before the run: kernel 1 8 a slice (the encoder, outside the
    graph); kernel 2, or 3 / 4 in the int8 modes, once a layer and pixel;
    kernel 11 4 products a layer and pixel."""
    slices, pixels = GEO_SLICES[name]
    want = {"block_attention_fwd": slices * 8}
    steps = slices * pixels * 8
    if label == "native":
        want["decode_attention"] = steps
    elif "pallas-live" in label:
        want["decode_attention_i8_live"] = steps
    else:
        want["decode_attention_i8"] = steps
    if "int8-pallas" in label:
        want["matmul_i8w"] = 4 * steps
    return want


def _geo_names():
    """{wrapper's __name__: the kernel's name in the kernels line}."""
    names = {w.__name__: n for n, w in _dp_wrappers().items()}
    names.update({"decode_attention_i8_cuda": "decode_attention_i8",
                  "decode_attention_i8_step_cuda": "decode_attention_i8",
                  "decode_attention_i8_live_cuda": "decode_attention_i8_live",
                  "decode_attention_i8_live_step_cuda": "decode_attention_i8_live",
                  "matmul_i8w_cuda": "matmul_i8w"})
    return names


def _zero_counts():
    from lvt_tpu_torch.ops._lib import COUNTED

    for f in COUNTED:
        f.launches = 0


def _launched():
    """{kernel name: launches} of every counted wrapper since _zero_counts."""
    from lvt_tpu_torch.ops._lib import COUNTED

    names, got = _geo_names(), {}
    for f in COUNTED:
        if f.launches:
            n = names.get(f.__name__, f.__name__)
            got[n] = got.get(n, 0) + f.launches
    return got


def _geo_rollout(card, name, label, opts):
    """One rollout configuration through tools/bench_sample_torch.py's run at
    b = 8, bf16, greedy: the first call (the graph's capture and one rollout)
    and GEO_ITERS timed calls, every count set to 0 just before and read just
    after; then slice 0 by the eager loop against the graph's codes. Returns
    the launches of one rollout."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_sample_torch as bs
    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    args = bs.parse_args(["--config", f"configs/vt/{name}.yaml", "--batch", str(GEO_B),
                          "--iters", str(GEO_ITERS), "--greedy", *opts])
    cfg = bs.load_cfg(args)
    want = _geo_rollout_expected(name, label)
    caps = _captures()
    _zero_counts()
    res, model, params, video, out = bs.run(cfg, args, torch.device("cuda"))
    got = _launched()
    calls = 1 + GEO_ITERS
    n_caps = _captures()[0] - caps[0]
    plan, c = model.plan, model.c
    slices, pixels = GEO_SLICES[name]
    sampled = sum(not (plan.slice_src[s].reshape(-1) // (16 * 16) < N_PRIME).all()
                  for s in range(plan.num_slices))
    check((sampled, plan.slice_src[0].size) == (slices, pixels),
          f"{name}: {sampled} sampled slices of {plan.slice_src[0].size} pixels, want "
          f"{slices} of {pixels}")
    check(got == {k: v * calls for k, v in want.items()},
          f"{name} {label}: launches {got} in {calls} rollouts, want {want} each")
    check(n_caps == 1, f"{name} {label}: {n_caps} graph captures, want 1")
    check(int(out.min()) >= 0 and int(out.max()) < c.nv,
          f"{name} {label}: codes in [{int(out.min())}, {int(out.max())}]")
    check(torch.equal(out[:, :, :N_PRIME], video[:, :, :N_PRIME]),
          f"{name} {label}: primed positions changed")
    check(not torch.equal(out, video), f"{name} {label}: nothing was sampled")
    # slice 0 by the eager loop (a SliceDecoder of its own), from the same
    # inputs as the rollout's first slice
    knobs = {"kv_dtype": args.kv, "weight_dtype": args.weights, "mm_dtype": args.mm,
             "attn_impl": args.attn}
    primed = plan.slice_src[0].reshape(-1) // (16 * 16) < N_PRIME
    t0 = time.perf_counter()
    with torch.no_grad():
        sidx = torch.zeros((GEO_B,), dtype=torch.int64, device=video.device)
        ctx, sl, _ = model.prepare_slices(video, sidx)
        zl = vt_encode(params["netG"], c, ctx, sidx)
        eager = sample_slice_incremental(params["netG"], c, plan.slice_shape, zl, sl, None,
                                         primed, 1.0, greedy=True, **knobs)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    graph_sl = model.prepare_slices(out, sidx)[1]
    check(torch.equal(eager, graph_sl),
          f"{name} {label}: slice 0 of the graph differs from the eager loop's "
          f"({int((eager != graph_sl).sum())} of {eager.numel()} codes)")
    per_slice = res["seconds_median"] / slices
    print(f"geometry {name} rollout b={GEO_B} bf16 greedy, {label} [{card}]: first call "
          f"{res['capture_seconds']:.3f} s (the graph's capture {res['graph_capture_seconds']:.3f} s "
          f"with its eager warm-up slice, then the rollout); graph of {res['graph_nodes']} nodes "
          f"({res['graph_nodes'] / pixels:.1f} a pixel); rollout {res['seconds_median']:.3f} s = "
          f"{slices} replays of {per_slice:.4f} s a slice, {res['frames_per_sec_per_chip']:.2f} "
          f"generated frames/s; peak memory {res['peak_memory_gb']:.3f} GiB; launches per "
          f"rollout {want}, exactly; codes in [0, {c.nv}), primed positions kept; slice 0 by "
          f"the eager loop ({eager_s:.2f} s) equal to the graph's, {eager.numel()} codes")
    print(f"  bench_sample_torch: {json.dumps(res)}")
    return {k: v * calls for k, v in want.items()}


def _geo_exact(card, name):
    """fp32, b = 1, full width, TF32 off: logits_for_entire_video_incremental
    (native cache: kernels 1 and 2) against logits_for_entire_video (the fused
    layer, kernel 7) on the card within GEO_EXACT_TOL, and the card's
    logits_for_entire_video against the CPU's within PATH_TOL. Returns the
    launches of the two card calls."""
    import numpy as np
    import torch

    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import VideoTransformer

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", f"{name}.yaml"))
    vt = VideoTransformer(cfg)
    dev = torch.device("cuda")
    params, _ = vt.init(torch.Generator().manual_seed(11), dev)
    video = torch.from_numpy(np.random.default_rng(11).integers(
        0, vt.c.nv, size=(1, vt.c.nc, T_FRAMES, 16, 16)))
    slices, pixels = GEO_SLICES[name]
    want_full = {"fused_layer_fwd": slices * 16}
    want_inc = {"block_attention_fwd": 8, "decode_attention": pixels * 8}
    _zero_counts()
    t0 = time.perf_counter()
    full = vt.logits_for_entire_video(params, video.to(dev))
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    got_full = _launched()
    _zero_counts()
    t0 = time.perf_counter()
    inc = vt.logits_for_entire_video_incremental(params, video.to(dev))
    torch.cuda.synchronize()
    t_inc = time.perf_counter() - t0
    got_inc = _launched()
    check(vt.fused and got_full == want_full,
          f"{name} exact: logits_for_entire_video launches {got_full}, want {want_full}")
    check(got_inc == want_inc,
          f"{name} exact: logits_for_entire_video_incremental launches {got_inc}, want {want_inc}")
    t0 = time.perf_counter()
    cpu = vt.logits_for_entire_video(to_device(params, "cpu"), video)
    t_cpu = time.perf_counter() - t0
    full, inc = full.cpu(), inc.cpu()
    shape = (1, T_FRAMES, 16, 16, vt.c.nc, vt.c.nv)
    check(tuple(inc.shape) == shape and inc.dtype == torch.float32 and
          bool(torch.isfinite(inc).all()), f"{name} exact: {tuple(inc.shape)} {inc.dtype}")
    e_inc = float((inc - full).abs().max())
    over = float(((inc - full).abs() - GEO_EXACT_TOL * full.abs()).max())
    e_cpu = float((full - cpu).abs().max())
    print(f"geometry {name} exact fp32 b=1 full width [{card}]: incremental (native cache) vs "
          f"logits_for_entire_video on the card max_abs_err {e_inc:.3g} (bound {GEO_EXACT_TOL:g} "
          f"+ {GEO_EXACT_TOL:g} |logits|, worst margin {over:.3g}); card vs CPU "
          f"logits_for_entire_video {e_cpu:.3g} (bound {PATH_TOL:g}; |logits| <= "
          f"{float(cpu.abs().max()):.3g}); seconds: card {t_full:.2f}, incremental {t_inc:.2f}, "
          f"CPU {t_cpu:.2f}; launches {want_full} and {want_inc}, exactly")
    check(over <= GEO_EXACT_TOL, f"{name} exact: incremental logits off by {e_inc}")
    check(e_cpu <= PATH_TOL, f"{name} exact: card vs CPU logits off by {e_cpu}")
    return {k: want_full.get(k, 0) + want_inc.get(k, 0) for k in {**want_full, **want_inc}}


def _geo_train(card, label, opts, n_steps, per_step, loss_keys):
    """tools/train_net_torch.py's main for ``n_steps`` steps, every count set
    to 0 just before and read just after; each step's launches (by kernel
    name) held to ``per_step``, its losses finite. Returns the trainer, the
    launches of the run and the per-step seconds."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.engine.trainer import Trainer

    steps = []
    inner = Trainer.train_step

    def recorded(self, batch):
        torch.cuda.synchronize()
        c0 = _launched()
        t0 = time.perf_counter()
        metrics = inner(self, batch)
        terms = {k: float(v) for k, v in metrics.items()}  # synchronizes
        took = time.perf_counter() - t0
        c1 = _launched()
        steps.append((took, terms, {k: v - c0.get(k, 0) for k, v in c1.items()
                                    if v != c0.get(k, 0)}))
        return metrics

    parse = default_argument_parser().parse_args
    try:
        Trainer.train_step = recorded
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(list(opts) + ["SOLVER.MAX_ITER", str(n_steps)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launched()
    finally:
        Trainer.train_step = inner
    peak = torch.cuda.max_memory_allocated()
    check(tr.state.step == n_steps and len(steps) == n_steps,
          f"{label}: {tr.state.step} steps taken, want {n_steps}")
    for key in loss_keys:
        vals = [s[1][key] for s in steps]
        check(all(np.isfinite(vals)), f"{label}: non-finite {key} {vals}")
    seen = [s[2] for s in steps]
    check(all(s == per_step for s in seen), f"{label}: launches per step {seen}, want {per_step}")
    sec = float(np.median([s[0] for s in steps[3:]]))
    batch = tr.cfg.SOLVER.IMS_PER_BATCH
    losses = ", ".join(f"{k} {steps[0][1][k]:.4f} -> {steps[-1][1][k]:.4f}" for k in loss_keys)
    print(f"geometry train {label} b={batch} bf16 [{card}]: {n_steps} steps in {wall:.2f} s with "
          f"set-up; median {sec:.4f} s/step over steps 4-{n_steps} (train_step, synchronized) = "
          f"{batch / sec:.1f} samples/s; first step {steps[0][0]:.3f} s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; launches per step {per_step}, exactly; {losses}")
    return tr, launches, steps


def phase_geometries(card):
    """Phase 20: DSSVT, DSTSVT and Base-VQVAE at full width, as their files
    stand. Returns {run: {kernel: launches}}."""
    import shutil
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_train_torch
    import generate_videos_torch as gvt
    from lvt_tpu_torch.data.datasets.bair import register_bair
    from lvt_tpu_torch.data.datasets.latents import register_latents
    from lvt_tpu_torch.ops import vq

    launches = {}
    for name, label, opts in GEO_ROLLOUTS:
        launches[f"{name} rollout, {label}"] = _geo_rollout(card, name, label, opts)
        torch.cuda.empty_cache()
    for name in GEO_SLICES:
        launches[f"{name} exact"] = _geo_exact(card, name)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_geo_")
    try:
        _write_latents(os.path.join(tmp, "latents"), 128, 1)
        register_latents("chip_smoke_geo_latents", os.path.join(tmp, "latents"))
        fused = {k: 16 for k in ("fused_layer_fwd", "ffn_half_bwd", "attn_half_bwd")}
        for name in ("DSSVT", "DSTSVT"):
            tr, launches[f"{name} train"], _ = _geo_train(
                card, name, ["--config-file", os.path.join(ROOT, "configs", "vt", f"{name}.yaml"),
                             "DATASETS.TRAIN", "('chip_smoke_geo_latents',)",
                             "DATALOADER.NUM_WORKERS", "8", "SOLVER.CHECKPOINT_PERIOD", "100000",
                             "OUTPUT_DIR", os.path.join(tmp, name)],
                GEO_TRAIN_STEPS, fused, ("loss_cross_entropy",))
            check(tr.model.fused and tr.cfg.SOLVER.IMS_PER_BATCH == 64
                  and tr.compute_dtype == torch.bfloat16,
                  f"{name} train: not the config's fused bf16 step at batch 64")
            del tr
            torch.cuda.empty_cache()

        _write_frames(os.path.join(tmp, "frames"), 16, T_FRAMES, 2)
        register_bair("chip_smoke_geo_frames", os.path.join(tmp, "frames"), "train", True)
        # Base-VQVAE is a _BASE_ file: RGB frames in, RGB frames out
        tr, launches["Base-VQVAE train"], steps = _geo_train(
            card, "Base-VQVAE",
            ["--config-file", os.path.join(ROOT, "configs", "vqvae", "Base-VQVAE.yaml"),
             "MODEL.ENCODER.IN_CHANNELS", "3", "MODEL.GENERATOR.OUT_CHANNELS", "3",
             "INPUT.FORMAT", "RGB", "DATASETS.TRAIN", "('chip_smoke_geo_frames',)",
             "DATALOADER.NUM_WORKERS", "4", "SOLVER.CHECKPOINT_PERIOD", "100000",
             "OUTPUT_DIR", os.path.join(tmp, "base_vqvae")],
            GEO_TRAIN_STEPS, {"nearest_indices": 1}, ("loss_reconstruction", "loss_commitment"))
        cb = tr.cfg.MODEL.CODEBOOK
        check((cb.NUM, cb.SIZE, cb.DIM, tr.cfg.SOLVER.IMS_PER_BATCH) == (1, 512, 256, 32),
              f"Base-VQVAE: codebook {cb.NUM} x {cb.SIZE} x {cb.DIM}, batch "
              f"{tr.cfg.SOLVER.IMS_PER_BATCH}")
        rec = [s[1]["loss_reconstruction"] for s in steps]
        check(rec[-1] < rec[0], f"Base-VQVAE: loss_reconstruction did not fall: {rec}")
        # the 5 example frames through the trained model: kernel 6 against the
        # plain fp32 search, then decoded
        model, params, state = tr.model, tr.state.params, tr.state.model_state
        frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"),
                                                          N_PRIME)).cuda()
        _zero_counts()
        with torch.no_grad():
            z_e, _ = model.encode_features(params, state, model.normalize(frames / 255.0))
            kernel = vq.encode_indices(z_e, state["netC"], use_kernel=True)
            got = _launched()
            plain = vq.encode_indices(z_e, state["netC"], use_kernel=False)
            decoded = model.decode(params, state, kernel)
        emb = state["netC"]["embedding"]
        n_diff, n_far, ok = _indices_ok(kernel.reshape(-1), plain.reshape(-1),
                                        z_e.reshape(-1, emb.shape[-1]), emb[0])
        check(got == {"nearest_indices": 1}, f"Base-VQVAE encode: launches {got}")
        check(tuple(kernel.shape) == (N_PRIME, 16, 16, 1) and ok,
              f"Base-VQVAE encode: indices {tuple(kernel.shape)}, {n_diff} differ from the "
              f"plain search, {n_far} of them no near-tie")
        check(tuple(decoded.shape) == (N_PRIME, 64, 64, 3) and bool(torch.isfinite(decoded).all()),
              f"Base-VQVAE decode: {tuple(decoded.shape)}, finite {bool(torch.isfinite(decoded).all())}")
        print(f"geometry Base-VQVAE encode/decode of example/*.png [{card}]: {kernel.numel()} "
              f"indices by kernel 6 (1 launch), {n_diff} differ from the plain fp32 search, "
              f"{n_far} of them no near-tie; {len(torch.unique(kernel))} distinct codes; decoded "
              f"{tuple(decoded.shape)} finite")
        launches["Base-VQVAE train"]["nearest_indices"] += 1
        del tr, model, params, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    _zero_counts()
    t0 = time.perf_counter()
    res = bench_train_torch.main(["--steps", "5"])
    launches["bench_train_torch"] = _launched()
    want = {"nearest_indices": 8, **{k: 16 * 8 for k in ("fused_layer_fwd", "ffn_half_bwd",
                                                          "attn_half_bwd")}}
    check(launches["bench_train_torch"] == want,
          f"bench_train_torch: launches {launches['bench_train_torch']}, want {want}")
    print(f"geometry bench_train_torch --steps 5 [{card}] ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(res)}")
    return launches



# --------------------------------------------------------------------------
# phase 21: the last reference tools and the training options
# --------------------------------------------------------------------------

QI_ITERS = 20  # quality_int8_torch's DSFVT training steps (its default 300: cut for the time limit)
QI_EVAL, QI_SAMPLE = 2, 8  # its teacher-forced videos and rollout batch
MFU_STEPS = 5  # timed steps of each mfu_torch train run (its default 20), after its 3 warm-up steps
# soak_train_torch: DSFVT b64 fused, 40 steps, a checkpoint every 10, killed
# once the second is on disk, resumed; an evaluation every 30 steps and at the
# end; 32 training videos, 2 held out
SOAK_ITERS, SOAK_EVAL, SOAK_TEST = 40, 30, 2
SOAK_ARGS = ["--iters", str(SOAK_ITERS), "--ckpt-period", "10", "--kill-after-ckpts", "2",
             "--kill-delay", "0.25", "--poll", "0.25", "--eval-period", str(SOAK_EVAL),
             "--videos", str(16 * SOAK_TEST), "--max-to-keep", "2", "--phase-timeout", "600"]
FUSED_STEP = {k: 16 for k in ("fused_layer_fwd", "ffn_half_bwd", "attn_half_bwd")}
UNFUSED_STEP = {"block_attention_fwd": 32, "block_attention_bwd": 16}  # per-layer remat
ROLLOUT = {"block_attention_fwd": 88, "decode_attention": 22528}  # DSFVT, 11 sampled slices


def _times(per, n):
    return {k: v * n for k, v in per.items()}


def _plus(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def _tool_run(card, label, fn, want):
    """fn() with every count set to 0 just before and read just after, the
    launches held to ``want`` exactly. Returns (fn's result, launches)."""
    import torch

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    got = _launched()
    check(got == want, f"{label}: launches {got}, want {want}")
    print(f"tools {label} [{card}] ({took:.1f} s): launches {want}, exactly; {json.dumps(res)}")
    return res, got


def phase_tools(card):
    """Phase 21: tools/quality_int8_torch.py, tools/mfu_torch.py (fused,
    unfused with the remat policies "dots" and "qkv", bf16 optimizer state,
    the sampler's roofline with a measured b = 8 rollout),
    tools/soak_train_torch.py (SIGKILL and --resume in child processes) and
    the profiler hook's trace read by tools/trace_summary_torch.py, DSFVT at
    full width. Returns {run: {kernel: launches}}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import mfu_torch
    import quality_int8_torch as qi
    import soak_train_torch
    import trace_summary_torch as ts

    launches = {}
    # quality_int8: training, the teacher passes (native: kernels 1 and 2; int8
    # cache: kernel 1, PyTorch's attention; the anchor: 256 of kernel 7 a call),
    # five b = 8 rollouts (native ones kernels 1 and 2, int8 ones kernel 1), the
    # two sampled sets scored in chunks of 8 (256 of kernel 7 each)
    want = _plus(_times(FUSED_STEP, QI_ITERS), {"fused_layer_fwd": 256 + 2 * 256},
                 {"block_attention_fwd": 8 + 8, "decode_attention": 256 * 8},
                 _times(ROLLOUT, 3), {"block_attention_fwd": 2 * 88})
    res, launches["quality_int8"] = _tool_run(
        card, "quality_int8_torch", lambda: qi.main(
            ["--iters", str(QI_ITERS), "--eval-batch", str(QI_EVAL),
             "--sample-batch", str(QI_SAMPLE)]), want)
    check(res["greedy_total_steps"] == 16 * 256 * 4
          and 0.0 <= res["greedy_code_agreement"] <= 1.0
          and all(np.isfinite(v) for v in res.values() if isinstance(v, float)),
          f"quality_int8: {res}")
    check(abs(res["tf_bits_per_dim_native"] - res["tf_bits_per_dim_xla_anchor"])
          <= 1e-2 * res["tf_bits_per_dim_xla_anchor"],
          "quality_int8: the cached native teacher pass strays from the anchor")
    torch.cuda.empty_cache()

    # mfu: the train step in four forms, then the sampler's roofline
    steps = 3 + MFU_STEPS + 0  # warm-up and timed steps
    peaks = {}
    for label, argv, per in (
            ("fused", [], FUSED_STEP),
            ("unfused, remat ''", ["TPU.FUSED_LAYER", "False"], UNFUSED_STEP),
            ("unfused, remat dots", ["--remat-policy", "dots", "TPU.FUSED_LAYER", "False"],
             UNFUSED_STEP),
            ("unfused, remat qkv", ["--remat-policy", "qkv", "TPU.FUSED_LAYER", "False"],
             UNFUSED_STEP),
            ("fused, bf16 optimizer state", ["SOLVER.OPT_STATE_DTYPE", "bfloat16"], FUSED_STEP)):
        held = torch.cuda.memory_allocated() / 2 ** 30  # the process's, before the run
        res, launches[f"mfu {label}"] = _tool_run(
            card, f"mfu_torch {label}", lambda a=argv: mfu_torch.main(
                ["--batch", "64", "--steps", str(MFU_STEPS)] + a), _times(per, steps))
        check(res["achieved_tflops"] > 0 and res["fused_layer"] == (per is FUSED_STEP),
              f"mfu {label}: {res}")
        peaks[label] = (res["s_per_it"], res["peak_memory_gb"],
                        round(res["peak_memory_gb"] - held, 3))
        torch.cuda.empty_cache()
    print(f"tools mfu_torch DSFVT b64 [{card}], each run's own (s a step, peak GiB "
          f"allocated, of it above what the process held before): {json.dumps(peaks)}")
    res, launches["mfu --sample"] = _tool_run(
        card, "mfu_torch --sample --kv native --batch 8 --measure --iters 1",
        lambda: mfu_torch.main(["--sample", "--kv", "native", "--batch", "8", "--measure",
                                "--iters", "1"]), _times(ROLLOUT, 2))
    check(res["measured_step_ms"] > 0 and 0 < res["sol_fraction"] < 1, f"mfu --sample: {res}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        # soak: the resumed child's launches, reported by the child itself
        t0 = time.perf_counter()
        res = soak_train_torch.main(SOAK_ARGS + ["--workdir", os.path.join(tmp, "soak")])
        names = _geo_names()
        got = {}
        for fn, n in res["resume_launches"].items():
            got[names.get(fn, fn)] = got.get(names.get(fn, fn), 0) + n
        start = res["resume_start_iter"]
        # the resumed child's steps, and its evaluations (BitsEvaluator: 256 of
        # kernel 7 a held-out video): every SOAK_EVAL-th step and the end
        evals = 1 + sum(1 for it in range(start + 1, SOAK_ITERS) if it % SOAK_EVAL == 0)
        want = _plus(_times(FUSED_STEP, SOAK_ITERS - start),
                     {"fused_layer_fwd": evals * SOAK_TEST * 256})
        check(got == want and res["checkpoints_kept"] == [30, 40]
              and res["killed_after_ckpt"] in (20, 30) and start == res["killed_after_ckpt"],
              f"soak: launches {got} (want {want}), {res}")
        launches["soak (resumed child)"] = got
        print(f"tools soak_train_torch [{card}] ({time.perf_counter() - t0:.1f} s): killed after "
              f"ckpt_{res['killed_after_ckpt']}, resumed there; resumed child's launches {want}, "
              f"exactly; {json.dumps(res)}")

        # the profiler hook: DSFVT fused at batch 16, the second of 3 steps traced
        from lvt_tpu_torch.config import get_cfg
        from lvt_tpu_torch.engine import TorchProfiler, Trainer

        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
        rng = np.random.default_rng(21)
        batches = [{"video": rng.integers(0, 512, size=(16, 4, 16, 16, 16)).astype(np.int32)}
                   for _ in range(3)]
        tr = Trainer(cfg, batches)
        hook = TorchProfiler(lambda trainer: trainer.iter == 1, os.path.join(tmp, "trace"))
        tr.register_hooks([hook])
        _, launches["profiler hook"] = _tool_run(card, "TorchProfiler, 3 DSFVT b16 steps",
                                                 lambda: tr.train(0, 3) or {},
                                                 _times(FUSED_STEP, 3))
        agg, total = ts.main([os.path.join(tmp, "trace"), "--top", "12"])
        wgmma = sum(n for k, (_, n) in agg.items() if "gemm_nt_wgmma" in k)
        check(os.listdir(os.path.join(tmp, "trace")) == ["torch_trace_iter1.json"]
              and total > 0 and wgmma >= 16,
              f"profiler hook: trace {os.listdir(os.path.join(tmp, 'trace'))}, device self "
              f"{total} us, {wgmma} gemm_nt_wgmma launches")
        print(f"tools trace_summary_torch of the hook's trace [{card}]: device self-time "
              f"{total / 1e3:.3f} ms in one step, {len(agg)} device functions, "
              f"{wgmma} gemm_nt_wgmma launches (kernels 7 and 8)")
        del tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# --------------------------------------------------------------------------
# phase 22: the sampler's int4 KV cache and multi-stream rollouts
# --------------------------------------------------------------------------
MODES_B = 8
# (label, sample_video's knobs, stream counts): streams 1, 2 and 4 natively,
# 1 and 2 with int8 KV + pallas (kernel 3; its 4 streams left out for the
# time limit: tests/test_torch_kernels.py holds 4 streams of it on the card)
STREAM_RUNS = (("native", {}, (1, 2, 4)),
               ("int8 KV + pallas", {"kv_cache_dtype": "int8", "attn_impl": "pallas"}, (1, 2)))
# int4 teacher logits, card vs CPU: tests/test_torch_sampler_int8.py's rule.
# Within MODES_LOGIT_TOL, unless one of the CPU run's roundings to an integer
# came within MODES_TIE_MARGIN of x.5 (in quantization steps): there the two
# sides' fp32 activations may round one step apart, and the bound is half the
# int4 cache's own gap to the native cache (the card's). The gap must stand
# at least 10x above MODES_LOGIT_TOL.
MODES_LOGIT_TOL = 2e-5
MODES_TIE_MARGIN = 1e-4


def _modes_expected(knobs, streams):
    """Launches of one b = 8 slice (256 pixels, 8 + 8 layers), stated before
    the run: kernel 1 8 (the encoder, at b rows, outside the graph); in each
    of the S streams kernel 2, or 3 in int8 + pallas, once a layer and
    pixel, kernel 11 4 products a layer and pixel; the int4 cache's
    attention launches none of them (PyTorch's ops)."""
    steps = streams * 256 * 8
    kv = knobs.get("kv_cache_dtype", "native")
    want = {"block_attention_fwd": 8}
    if kv == "native":
        want["decode_attention"] = steps
    elif kv == "int8":
        want["decode_attention_i8"] = steps
    if knobs.get("weight_dtype") == "int8-pallas":
        want["matmul_i8w"] = 4 * steps
    return want


def _busy_profile(fn):
    """fn() once unprofiled, then once under torch.profiler, each
    synchronized: (result, wall s, wall s under the profiler, device
    activities, their summed device s, the device's busy s: the union of
    their intervals, so that activities overlapping on several streams count
    once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    summed = sum(b - a for a, b in spans) / 1e9
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return out, wall, wall_prof, len(spans), summed, busy / 1e9


def phase_sampler_modes(card):
    """Phase 22: the int4 KV cache and multi-stream rollouts (``streams``) at
    DSFVT's full width, bf16, greedy unless stated, each rollout the last
    slice (256 pixels, one frame) of a seeded video of b = 8, through
    ``sample_video`` and the slice's CUDA graph, every count set to 0 just
    before the graph rollout and read just after, held to _modes_expected.
    Streams (STREAM_RUNS): at S > 1 the graph's codes equal its eager warm-up's
    (the loop run eagerly on the S branches' streams) and one-stream eager
    rollouts of each block of b / S rows; agreement with the one-stream
    b = 8 rollout; at every S the graph's nodes, a replay's seconds and busy
    share. A temperature rollout at 2 streams: the graph's codes and the
    caller's generator equal the eager loop's from the same state. int4: the
    graph's codes equal the eager loop's, the agreement with the native
    rollout, the cache's bytes exactly half of int8's; one fp32 video's
    teacher logits through logits_for_entire_video_incremental on the card
    against the CPU's (MODES_LOGIT_TOL, near-tie rule), beside the int8
    cache's gap to native; one slice of bench.py's program (b = 1024) with
    the int4 cache: capture and replay seconds, peak memory. (Phase 11 holds
    the one-stream graphs of the native and int8 + pallas modes to the eager
    loop.) Returns {run: {kernel: launches}}."""
    import numpy as np
    import torch

    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models import cast_floats, to_device
    from lvt_tpu_torch.models.vt import VideoTransformer, vt_encode
    from lvt_tpu_torch.models.vt_incremental import SliceDecoder

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    dev, b = torch.device("cuda"), MODES_B
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    vt = VideoTransformer(cfg, T=T_FRAMES, H=16, W=16)
    c, plan = vt.c, vt.plan
    params32, _ = vt.init(torch.Generator().manual_seed(0), dev)
    params = cast_floats(params32, torch.bfloat16)
    rng = np.random.default_rng(22)
    video = torch.from_numpy(rng.integers(0, c.nv, size=(b, c.nc, T_FRAMES, 16, 16))).to(dev)
    n_prime = T_FRAMES - 1
    frames = [plan.slice_src[s].reshape(-1) // (16 * 16) for s in range(plan.num_slices)]
    sampled = [s for s in range(plan.num_slices) if not (frames[s] < n_prime).all()]
    check(len(sampled) == 1 and plan.slice_src[sampled[0]].size == 256,
          f"sampler modes: slices {sampled} sampled, want one of 256 pixels")
    s_last = sampled[0]
    primed_t = torch.as_tensor(frames[s_last] < n_prime, device=dev)
    with torch.no_grad():
        sidx = torch.full((b,), s_last, dtype=torch.int64, device=dev)
        ctx, sl_in, _ = vt.prepare_slices(video, sidx)
        zl = vt_encode(params["netG"], c, ctx, sidx)
    launches, parts, t_part = {}, [], [time.perf_counter()]

    def part(name):  # seconds of each part of the phase, printed at its end
        now = time.perf_counter()
        parts.append(f"{name} {now - t_part[0]:.1f}")
        t_part[0] = now

    def rollout(knobs, rows=None, eager=False, gen=None, greedy=True):
        v = video if rows is None else video[rows]
        with torch.no_grad():
            return vt.sample_video(params, v, gen, n_prime=n_prime, greedy=greedy, temp=1.0,
                                   _eager=eager, **knobs)

    def graph_run(label, knobs, streams=1, eager=False):
        """The graph rollout with its counts, a profiled replay of its slice,
        the eager loop's codes where ``eager``, else at S > 1 the warm-up's;
        returns (codes, the graph)."""
        run = dict(knobs, streams=streams)
        want = _modes_expected(knobs, streams)
        _zero_counts()
        caps = _captures()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rollout(run)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        took = _launched()
        n_caps = _captures()[0] - caps[0]
        name = f"{label}, streams {streams}"
        check(took == want, f"sampler modes, {name}: launches {took}, want {want}")
        check(n_caps == 1, f"sampler modes, {name}: {n_caps} graph captures, want 1")
        check(int(got.min()) >= 0 and int(got.max()) < c.nv
              and torch.equal(got[:, :, :n_prime], video[:, :, :n_prime]),
              f"sampler modes, {name}: codes out of range or primed frames changed")
        launches[name] = took
        graph = vt._slice_graph_slot.graph
        got_sl = vt.prepare_slices(got, sidx)[1]
        held = ""
        if eager:
            t0 = time.perf_counter()
            other = rollout(run, eager=True)
            held = f"; the eager loop {time.perf_counter() - t0:.3f} s, codes equal"
            check(torch.equal(other, got), f"sampler modes, {name}: the graph's codes differ "
                                           f"from the eager loop's "
                                           f"({int((other != got).sum())} codes)")
        elif streams > 1:
            held = "; codes equal to the eager warm-up's on the branches' streams"
            check(torch.equal(graph.warmup_out, got_sl),
                  f"sampler modes, {name}: the graph's codes differ from its eager warm-up's "
                  f"({int((graph.warmup_out != got_sl).sum())} codes)")
        out, wall, wall_prof, n_act, summed, busy = _busy_profile(
            lambda: graph(zl, sl_in, primed_t))
        check(torch.equal(out, got_sl),
              f"sampler modes, {name}: a replay of the slice's graph differs from the rollout")
        print(f"sampler modes b={b} bf16 greedy, {name} [{card}]: first call {first:.3f} s (the "
              f"graph's capture {graph.capture_seconds:.3f} s, its eager warm-up "
              f"{graph.warmup_seconds:.3f} s); graph of {graph.nodes} nodes ("
              f"{graph.nodes / 256:.1f} a pixel); one replay {wall:.4f} s ({wall_prof:.4f} s "
              f"under the profiler), device busy {busy:.4f} s = {100 * busy / wall_prof:.1f}% "
              f"of the profiled wall time, kernels' time summed over streams {summed:.4f} s "
              f"({n_act} activities, {n_act / 256:.1f} a pixel){held}; launches {took}, "
              "exactly")
        return got, graph

    # ---- streams: the graph's S branches against one-stream rollouts
    native = None
    for label, knobs, counts in STREAM_RUNS:
        one = None
        for streams in counts:
            got, _ = graph_run(label, knobs, streams)
            if streams == 1:
                one = got
                native = got if native is None else native
                part(f"{label} S=1")
                continue
            bs = b // streams
            t0 = time.perf_counter()
            for s in range(streams):
                rows = slice(s * bs, (s + 1) * bs)
                block = rollout(knobs, rows, eager=True)
                check(torch.equal(got[rows], block),
                      f"sampler modes, {label}, streams {streams}: rows {rows.start}-"
                      f"{rows.stop - 1} differ from their one-stream rollout "
                      f"({int((got[rows] != block).sum())} codes)")
            agree = float((got[:, :, n_prime:] == one[:, :, n_prime:]).float().mean())
            print(f"  {label}, streams {streams}: every block of {bs} rows equal to its one-"
                  f"stream eager rollout ({time.perf_counter() - t0:.2f} s); codes equal to the "
                  f"one-stream b = {b} rollout's: {agree:.4f} of the sampled")
            part(f"{label} S={streams}")
        vt._slice_graph_slot = None
        torch.cuda.empty_cache()

    # ---- a temperature rollout at 2 streams: graph and eager from one state
    outs = {}
    for eager in (True, False):
        gen = torch.Generator(device=dev).manual_seed(5)
        _zero_counts()
        codes = rollout({"streams": 2}, eager=eager, gen=gen, greedy=False)
        if not eager:
            launches["native, streams 2, temperature"] = _launched()
        outs[eager] = (codes, gen.get_state())
    check(torch.equal(outs[True][0], outs[False][0]) and torch.equal(outs[True][1],
                                                                     outs[False][1]),
          "sampler modes, temperature at 2 streams: the graph's draws or the generator's state "
          "differ from the eager loop's")
    check(not torch.equal(outs[False][0][:, :, n_prime:], native[:, :, n_prime:]),
          "sampler modes, temperature at 2 streams: the draws equal the greedy codes")
    print(f"sampler modes b={b} bf16, native, streams 2, temperature 1.0 [{card}]: the graph's "
          "codes and the caller's generator state equal the eager loop's from the same state")
    vt._slice_graph_slot = None
    part("temperature S=2")

    # ---- the int4 cache at b = 8
    bytes8 = SliceDecoder(params["netG"], c, plan.slice_shape, b, dev,
                          kv_dtype="int8").cache_bytes()
    got, graph = graph_run("int4 KV", {"kv_cache_dtype": "int4"}, eager=True)
    bytes4 = graph.decoder.cache_bytes()
    check(2 * bytes4 == bytes8, f"sampler modes, int4: the cache holds {bytes4} bytes, int8's "
                                f"{bytes8}; want exactly half")
    agree = float((got[:, :, n_prime:] == native[:, :, n_prime:]).float().mean())
    print(f"  int4 KV: K and V caches {bytes4 / 2 ** 20:.1f} MiB, exactly half of the int8 "
          f"cache's {bytes8 / 2 ** 20:.1f} MiB; greedy codes equal to the native rollout's: "
          f"{agree:.4f} of the sampled")
    check(agree >= GREEDY_FLOOR, f"sampler modes, int4: greedy agreement with the native "
                                 f"rollout {agree}, under the floor {GREEDY_FLOOR}")
    vt._slice_graph_slot = graph = None
    torch.cuda.empty_cache()
    part("int4 b=8")

    # ---- int4 teacher logits: one fp32 video on the card and on the CPU
    video1 = torch.from_numpy(rng.integers(0, c.nv, size=(1, c.nc, T_FRAMES, 16, 16)))
    lg = {}
    for kv in ("native", "int8", "int4"):
        _zero_counts()
        with torch.no_grad():
            lg[kv] = vt.logits_for_entire_video_incremental(params32, video1.to(dev),
                                                            kv_cache_dtype=kv).cpu()
        launches[f"teacher logits fp32, {kv} cache"] = _launched()
    margin = [float("inf")]
    inner_round = torch.round

    def recording_round(x, *args, **kwargs):
        frac = x.detach().float()
        margin[0] = min(margin[0], float((frac - frac.floor() - 0.5).abs().min()))
        return inner_round(x, *args, **kwargs)

    cpu32 = to_device(params32, "cpu")
    t0 = time.perf_counter()
    torch.round = recording_round
    try:
        with torch.no_grad():
            cpu4 = vt.logits_for_entire_video_incremental(cpu32, video1, kv_cache_dtype="int4")
    finally:
        torch.round = inner_round
    cpu_s = time.perf_counter() - t0

    def rms(x):
        return float(x.pow(2).mean().sqrt())

    err = float((lg["int4"] - cpu4).abs().max())
    gap4 = float((lg["int4"] - lg["native"]).abs().max())
    gap8 = float((lg["int8"] - lg["native"]).abs().max())
    bound = MODES_LOGIT_TOL if margin[0] >= MODES_TIE_MARGIN else 0.5 * gap4
    print(f"sampler modes, int4 teacher logits fp32 b=1, one video (16 slices) [{card}]: card vs "
          f"cpu max {err:.4g} (rms {rms(lg['int4'] - cpu4):.3g}), bound {bound:.4g} (the CPU's "
          f"roundings came within {margin[0]:.3g} of x.5, "
          f"{'under' if margin[0] < MODES_TIE_MARGIN else 'over'} MODES_TIE_MARGIN); gap to "
          f"the native cache max {gap4:.4g} (rms {rms(lg['int4'] - lg['native']):.3g}), the "
          f"int8 cache's {gap8:.4g} (rms {rms(lg['int8'] - lg['native']):.3g}); |logits| <= "
          f"{float(lg['native'].abs().max()):.3g}; the CPU's pass {cpu_s:.1f} s")
    check(np.isfinite(lg["int4"].numpy()).all(), "sampler modes: non-finite int4 logits")
    check(gap4 >= 10 * MODES_LOGIT_TOL, f"sampler modes: the int4 gap {gap4} is too near the bound")
    check(err <= bound, f"sampler modes: int4 teacher logits card vs cpu {err}, bound {bound}")
    part("int4 teacher logits")

    # ---- bench.py's program with the int4 cache, one slice at b = 1024
    B = BENCH_BATCH
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, c.nv, size=(B, c.nc, T_FRAMES, 16, 16))).to(dev)
    thw = plan.slice_src[N_PRIME].size
    primed = torch.zeros(thw, dtype=torch.bool, device=dev)
    knobs = {"kv_dtype": "int4", "weight_dtype": "native", "mm_dtype": "native",
             "attn_impl": "xla", "streams": 1}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        sidx = torch.full((B,), N_PRIME, dtype=torch.int64, device=dev)
        ctx, sl, _ = vt.prepare_slices(codes, sidx)
        zl = vt_encode(params["netG"], c, ctx, sidx)
        t0 = time.perf_counter()
        graph = vt._slice_graph(params, zl, sl, primed, knobs, 1.0, True)
        capture = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = graph(zl, sl, primed)
        int(out[0, 0, 0, 0, 0])
        torch.cuda.synchronize()
        replay = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == tuple(sl.shape) and int(out.min()) >= 0 and int(out.max()) < c.nv,
          "sampler modes, bench slice int4: codes of the wrong shape or out of range")
    print(f"bench.py's program with --kv int4, one slice: DSFVT b={B} bf16 int4 KV xla greedy, "
          f"{thw} pixels, graph [{card}]: captured in {capture:.3f} s (warm-up, one eager slice, "
          f"{graph.warmup_seconds:.3f} s); one replay {replay:.3f} s; the K and V caches "
          f"{graph.decoder.cache_bytes() / 2 ** 30:.3f} GiB; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; codes in [0, {c.nv})")
    vt._slice_graph_slot = graph = None
    torch.cuda.empty_cache()
    part("int4 b=1024")
    print(f"sampler modes: part seconds {', '.join(parts)}")
    return launches


# --------------------------------------------------------------------------
# phase 23: ROADMAP item 8 (the context-encode formulations, the UNet, GanTrainer)
# --------------------------------------------------------------------------
# one slice's context encode at b = CTX_B: (config, dtype)
CTX_CASES = (("DSSVT", "bfloat16"), ("DSTSVT", "bfloat16"), ("DSFVT", "float32"))
CTX_B, CTX_ITERS = 1024, 3
CTX_FORMS = ("gather_sum", "chunk", "chain", "onehot", "minor", "")  # "" is auto
# fp32, every formulation against gather_sum: sums of the same rows in
# another order, |diff| / max |gather_sum|. bf16: chain, chunk and onehot
# round their accumulator after each of up to S - 1 adds and gather_sum
# rounds once, so |diff| <= S * 2^-8 * sum |rows| elementwise (S = nc * K
# terms).
CTX_FP32_TOL = 1e-5
# the per-slot backward against autograd through the plain gather, fp32,
# relative Frobenius: the same fp32 sums in another order
CTX_GRAD_TOL = 1e-5
ITEM8_TRAIN, ITEM8_B, ITEM8_STEPS = ("DSFVT", "DSTSVT"), 64, 3
UNET_B, UNET_TOL = 8, 1e-4  # the UNet card vs CPU, fp32, TF32 off
GAN_ITERS = 400


def _ctx_case(name, b, dtype, seed):
    """One slice's context encode of ``name`` on its 16 x 16 x 16 latent
    grid, on the card: (ctx, table, VTConfig); codes uniform in [-1, nv)
    (-1 a pad), the table N(0, 1) in ``dtype``."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.models.vt import VTConfig
    from lvt_tpu_torch.ops.subscale import shifted_shape

    c = VTConfig.from_cfg(gvt.load_config(os.path.join(ROOT, "configs", "vt", f"{name}.yaml")))
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = shifted_shape(*c.stride, T_FRAMES, 16, 16, *c.kernel)
    ctx = torch.randint(-1, c.nv, (b, c.nc, *shape), generator=g, device="cuda",
                        dtype=torch.int32)
    table = torch.randn((c.nc, *c.kernel, c.nv, c.de), generator=g, device="cuda")
    return ctx, table.to(getattr(torch, dtype)), c


def _ctx_predicted_bytes(impl, b, S, thw, de, nv, isz):
    """Device bytes a formulation holds at its peak beyond its inputs: the
    int32 indices, the padded table, the output and what the formulation
    makes (ops/conv.py _ctx_encode_impl)."""
    from lvt_tpu_torch.ops.conv import ctx_chunk

    idx, flat, out = 4 * b * S * thw, S * (nv + 1) * de * isz, b * thw * de * isz
    # a bf16 sum over the slot axis adds in an fp32 temporary of the output's shape
    tmp32 = 4 * b * thw * de if isz < 4 else 0
    if impl == "chain":  # the accumulator, one slot's rows and its indices
        return idx + flat + 2 * out + 4 * b * thw
    if impl == "chunk":  # one chunk's rows, or its indices, beside its sum
        ch = ctx_chunk(b, S, thw, de, isz) * b * thw
        return idx + flat + out + ch * de * isz + max(4 * ch, out + tmp32)
    if impl == "onehot":  # one slot's one-hot as bool and cast, its product
        return idx + flat + 2 * out + b * thw * (nv + 1) * (1 + isz) + 8 * b * thw
    if impl == "minor":  # the indices' transposed copy, then the sum's output
        return idx + flat + b * S * thw * de * isz + max(idx, out + tmp32)
    return idx + flat + b * S * thw * de * isz + out + tmp32  # gather_sum


def phase_ctx_encode(card):
    """Phase 23, first part: one slice's subscale_context_encode in every
    LVT_CTX_IMPL formulation at b = CTX_B (alone on the card)."""
    import torch

    from lvt_tpu_torch.ops import conv

    saved = {k: os.environ.pop(k, None) for k in ("LVT_CTX_IMPL", "LVT_CTX_CHUNK")}
    try:
        for case, (name, dtype) in enumerate(CTX_CASES):
            ctx, table, c = _ctx_case(name, CTX_B, dtype, 30 + case)
            kt, kh, kw = c.kernel
            S = c.nc * kt * kh * kw
            t, h, w = (n // s for n, s in zip((T_FRAMES, 16, 16), c.stride))
            thw, isz = t * h * w, table.element_size()
            auto = conv.ctx_encode_impl(CTX_B, S, thw, c.de, isz)
            check(auto == "chain", f"ctx encode {name} b={CTX_B} {dtype}: auto picks {auto}")
            with torch.no_grad():
                os.environ["LVT_CTX_IMPL"] = "chain"
                absum = conv._ctx_encode_impl(ctx, table.float().abs(), c.stride)
                rows = []
                ref = None
                for impl in CTX_FORMS:
                    os.environ["LVT_CTX_IMPL"] = impl
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    out = conv.subscale_context_encode(ctx, table, None, c.stride, c.nv)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() - base
                    ms = host_ms([lambda: conv.subscale_context_encode(ctx, table, None, c.stride,
                                                                      c.nv)], CTX_ITERS)
                    check(tuple(out.shape) == (CTX_B, t, h, w, c.de) and out.dtype == table.dtype
                          and bool(torch.isfinite(out).all()),
                          f"ctx encode {name} {impl or 'auto'}: output {tuple(out.shape)} "
                          f"{out.dtype}, or not finite")
                    if ref is None:
                        ref = out
                    diff = (out.float() - ref.float()).abs()
                    if dtype == "float32":
                        gap = float(diff.max()) / float(ref.abs().max())
                        ok = gap <= CTX_FP32_TOL
                    else:  # in bf16 roundings (2^-8) of sum |rows|
                        gap = float((diff / absum.clamp_min(1e-30)).max()) / 2 ** -8
                        ok = gap <= S
                    pred = _ctx_predicted_bytes(auto if not impl else impl, CTX_B, S, thw,
                                                c.de, c.nv, isz)
                    rows.append(f"{impl or 'auto (' + auto + ')'} {ms:.3f} ms, peak "
                                f"{peak / 2 ** 30:.3f} GiB (predicted {pred / 2 ** 30:.3f}), gap "
                                f"{gap:.3g}")
                    check(ok, f"ctx encode {name} {dtype} {impl or 'auto'}: gap to gather_sum "
                              f"{gap:.3g}")
                    if not impl:
                        check(peak < 0.25 * _ctx_predicted_bytes("gather_sum", CTX_B, S, thw,
                                                                 c.de, c.nv, isz),
                              f"ctx encode {name}: auto's peak {peak / 2 ** 30:.2f} GiB")
                    del out
            gap_unit = ("max|diff| / max|gather_sum| (bound "
                        f"{CTX_FP32_TOL:g})" if dtype == "float32" else
                        f"in bf16 roundings of sum|rows| (bound S = {S})")
            print(f"ctx encode {name} one slice b={CTX_B} {dtype} [{card}]: S = nc*K = {S} slots "
                  f"x {thw} positions, de {c.de}, gather_sum's intermediate "
                  f"{CTX_B * S * thw * c.de * isz / 2 ** 30:.2f} GiB, auto picks {auto}; ms "
                  f"(CUDA events around {CTX_ITERS} eager calls), peak above the inputs, gap to "
                  f"gather_sum {gap_unit}: " + "; ".join(rows))
            del ctx, table, absum, ref
            torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _index_put_table_grad(ctx, g, stride, kernel, nv, dtype):
    """The table gradient as per-slot segment sums by ``index_put_`` with
    accumulate (sorted, so the same from run to run) instead of the port's
    one-hot products: a yardstick, never on a path (on the card each call
    waits for the device, which stalls a train step)."""
    from lvt_tpu_torch.ops import conv

    kt, kh, kw = kernel
    nc, de = ctx.shape[1], g.shape[-1]
    S = nc * kt * kh * kw
    gidx, _ = conv._ctx_gather_indices(ctx, stride, (nc, kt, kh, kw, nv, de))
    gf = g.reshape(-1, de).float()
    dflat = gf.new_zeros(S, nv + 1, de)
    for s in range(S):
        dflat[s].index_put_((gidx[:, s].reshape(-1) - s * (nv + 1),), gf, accumulate=True)
    return dflat[:, 1:].reshape(nc, kt, kh, kw, nv, de).to(dtype)


def _plain_ctx_encode(ctx, table, bias, stride, nv):
    """The context sum as the port computed it before LVT_CTX_IMPL: the
    (b, nc*K, thw, de) gather summed, with autograd through take_rows."""
    from lvt_tpu_torch.ops import conv
    from lvt_tpu_torch.ops.embedding import take_rows

    gidx, (t, h, w) = conv._ctx_gather_indices(ctx, stride, table.shape)
    emb = take_rows(conv._slot_rows(table), gidx).sum(dim=1)
    emb = emb.reshape(ctx.shape[0], t, h, w, table.shape[-1])
    return emb + bias if bias is not None else emb


class _ToyGan:
    """tests/test_torch_gan.py's toy GAN on ``device``: G a 2-layer MLP
    noise -> sample, D a 2-layer MLP sample -> logit, the noise drawn from
    the step's generator."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, gen, device):
        import torch

        return {"w1": (torch.randn(4, 16, generator=gen) * 0.5).to(device),
                "w2": (torch.randn(16, 2, generator=gen) * 0.5).to(device),
                "b2": torch.zeros(2, device=device)}, {}

    def init_discriminator(self, gen, device):
        import torch

        return {"w1": (torch.randn(2, 16, generator=gen) * 0.5).to(device),
                "w2": (torch.randn(16, 1, generator=gen) * 0.5).to(device)}

    def gen_samples(self, params, z):
        import torch

        return torch.tanh(z @ params["w1"]) @ params["w2"] + params["b2"]

    def _fake(self, params, batch, gen):
        import torch

        x = batch["x"]
        return self.gen_samples(params, torch.randn(x.shape[0], 4, generator=gen).to(x.device))

    def _disc(self, d_params, x):
        import torch

        return (torch.tanh(x @ d_params["w1"]) @ d_params["w2"])[:, 0]

    def train_loss(self, params, state, batch, gen):
        fake = self._fake(params, batch, gen)
        loss = ((fake.mean(0) - batch["x"].mean(0)) ** 2).mean()
        return loss, ({"loss_sup": loss}, state)

    def generator_loss(self, params, d_params, state, batch, gen):
        from lvt_tpu_torch.models.loss import gan_loss

        loss = gan_loss(self.cfg, self._disc(d_params, self._fake(params, batch, gen)), True)
        return loss, ({"loss_g": loss}, state)

    def discriminator_loss(self, params, d_params, state, batch, gen):
        from lvt_tpu_torch.models.loss import gan_loss

        fake = self._fake(params, batch, gen).detach()
        loss = (gan_loss(self.cfg, self._disc(d_params, batch["x"]), True)
                + gan_loss(self.cfg, self._disc(d_params, fake), False))
        return loss, {"loss_d": loss}


def phase_item8(card):
    """Phase 23, second part: the per-slot backward and a bf16 train step
    (DSFVT, DSTSVT b = 64), the UNet card vs CPU, the toy GAN on the card."""
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    import lvt_tpu_torch.models.vt as vt_mod
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.ops import conv

    parts, t_part = [], [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts.append(f"{name} {now - t_part[0]:.1f}")
        t_part[0] = now

    # ---- the per-slot backward against autograd through the plain gather
    for case, name in enumerate(ITEM8_TRAIN):
        res = {}
        for dtype in ("float32", "bfloat16"):
            ctx, table, c = _ctx_case(name, ITEM8_B, dtype, 40 + case)
            t, h, w = (n // s for n, s in zip((T_FRAMES, 16, 16), c.stride))
            g = torch.randn((ITEM8_B, t, h, w, c.de), generator=torch.Generator(
                device="cuda").manual_seed(50 + case), device="cuda").to(table.dtype)
            mine = table.clone().requires_grad_(True)
            plain = table.clone().requires_grad_(True)
            out = conv.subscale_context_encode(ctx, mine, None, c.stride, c.nv)
            ref = _plain_ctx_encode(ctx, plain, None, c.stride, c.nv)
            out.backward(g)
            ref.backward(g, retain_graph=True)  # timed again below
            rel = float((mine.grad.float() - plain.grad.float()).norm()
                        / plain.grad.float().norm())
            other = _index_put_table_grad(ctx, g, c.stride, c.kernel, c.nv, table.dtype)
            rel_ip = float((other.float() - plain.grad.float()).norm()
                           / plain.grad.float().norm())
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            conv.ctx_table_grad(ctx, g, c.stride, c.kernel, c.nv, table.dtype)
            peak = torch.cuda.max_memory_allocated() - base
            ms = [host_ms([f], CTX_ITERS) for f in (
                lambda: conv.ctx_table_grad(ctx, g, c.stride, c.kernel, c.nv, table.dtype),
                lambda: _index_put_table_grad(ctx, g, c.stride, c.kernel, c.nv, table.dtype),
                lambda: torch.autograd.grad(ref, plain, g, retain_graph=True))]
            res[dtype] = (rel, rel_ip, peak, ms)
            del ctx, table, g, mine, plain, out, ref, other
        rel = res["float32"][0]
        print(f"ctx encode backward {name} b={ITEM8_B} one slice [{card}]: table gradient vs "
              f"autograd through the plain gather (take_rows), relative Frobenius: the port's "
              f"per-slot one-hot products fp32 {rel:.3g} (bound {CTX_GRAD_TOL:g}), bf16 "
              f"{res['bfloat16'][0]:.3g}; per-slot index_put_ (yardstick) fp32 "
              f"{res['float32'][1]:.3g}, bf16 {res['bfloat16'][1]:.3g}; ms (CUDA events around "
              f"{CTX_ITERS} eager calls), one-hot / index_put_ / plain gather's autograd: "
              + "; ".join(
                  f"{dt} {m[0]:.3f} / {m[1]:.3f} / {m[2]:.3f}, one-hot peak above its inputs "
                  f"{p / 2 ** 20:.1f} MiB" for dt, (_, _, p, m) in res.items()))
        check(rel <= CTX_GRAD_TOL, f"ctx encode backward {name}: off by {rel} (relative)")
    torch.cuda.empty_cache()
    part("backward")

    # ---- one bf16 train step, DSFVT and DSTSVT at b = 64, beside the plain gather's
    fused = {"fused_layer_fwd": 16, "ffn_half_bwd": 16, "attn_half_bwd": 16}
    port_grad = conv.ctx_table_grad
    for case, name in enumerate(ITEM8_TRAIN):
        cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", f"{name}.yaml"))
        tr = Trainer(cfg, iter(()), device="cuda")
        check(tr.model.fused and tr.compute_dtype == torch.bfloat16,
              f"item 8 train {name}: not the config's fused bf16 step")
        batch = {"video": torch.randint(0, tr.model.c.nv, (ITEM8_B, tr.model.c.nc, T_FRAMES, 16,
                                                           16), device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(60))}
        res = {k: ([], 0, []) for k in ("one-hot (the port)", "plain gather", "index_put_")}
        tr.train_step(batch)  # warm-up
        # in turns, each from the state the turn before left
        for label in ("one-hot (the port)", "plain gather", "index_put_", "index_put_",
                      "plain gather", "one-hot (the port)"):
            secs, peak, losses = res[label]
            if label == "plain gather":
                vt_mod.subscale_context_encode = _plain_ctx_encode
            elif label == "index_put_":
                conv.ctx_table_grad = _index_put_table_grad
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(ITEM8_STEPS):
                    c0 = _launched()
                    t0 = time.perf_counter()
                    losses.append(float(tr.train_step(batch)["loss_cross_entropy"]))
                    secs.append(time.perf_counter() - t0)
                    took = {k: v - c0.get(k, 0) for k, v in _launched().items()
                            if v != c0.get(k, 0)}
                    check(took == fused, f"item 8 train {name} ({label}): launches {took}, "
                                         f"want {fused}")
                res[label] = (secs, max(peak, torch.cuda.max_memory_allocated()), losses)
            finally:
                vt_mod.subscale_context_encode = conv.subscale_context_encode
                conv.ctx_table_grad = port_grad
            check(all(np.isfinite(losses)), f"item 8 train {name} ({label}): losses {losses}")
        print(f"item 8 train {name} b={ITEM8_B} bf16 fused [{card}], one step (train_step, "
              f"synchronized by its loss; the context encode's backward in turns one-hot, plain "
              f"gather, index_put_, index_put_, plain gather, one-hot, {ITEM8_STEPS} steps each "
              f"after one warm-up): " + "; ".join(
                  f"{label} median {np.median(s):.4f} s (range {min(s):.4f}-{max(s):.4f}), "
                  f"max_memory_allocated {p / 2 ** 30:.2f} GiB, losses {ls[0]:.4f} -> "
                  f"{ls[-1]:.4f}" for label, (s, p, ls) in res.items())
              + f"; launches per step {fused}, exactly")
        del tr, batch
        torch.cuda.empty_cache()
    part("train steps")

    # ---- the UNet, card vs CPU, fp32 with TF32 off
    import lvt_tpu_torch.models.unet as unet

    ucfg = gvt.load_config(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"),
                           ["MODEL.ENCODER.NAME", "UNet", "MODEL.ENCODER.OUT_CHANNELS", "2"])
    from lvt_tpu_torch.models.encoders import build_encoder

    net = build_encoder(ucfg)
    check(isinstance(net, unet.UNetNet), "UNet: the registry built another encoder")
    p, s = net.init(torch.Generator().manual_seed(4))
    codes = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (UNET_B, 16, 16)))
    errs = {}
    with torch.no_grad():
        for train in (True, False):
            y_cpu, s_cpu = net.apply(p, s, codes, train=train)
            pc, sc = to_device(copy.deepcopy(p), "cuda"), to_device(copy.deepcopy(s), "cuda")
            y, s_card = net.apply(pc, sc, codes.cuda(), train=train)
            ms = host_ms([lambda: net.apply(pc, sc, codes.cuda(), train=train)], CTX_ITERS)
            check(tuple(y.shape) == (UNET_B, 16, 16, 2) and float(y.min()) >= 0
                  and float(y.max()) <= 1, "UNet: output of the wrong shape or outside [0, 1]")
            err = float((y.cpu() - y_cpu).abs().max())
            st_err = max(float((a.cpu() - b).abs().max() / max(1.0, float(b.abs().max())))
                         for a, b in zip(_leaves(s_card), _leaves(s_cpu)))
            errs["train" if train else "eval"] = (err, st_err, ms)
    print(f"UNet b={UNET_B} 16x16 codes fp32, TF32 off [{card}]: card vs CPU " + "; ".join(
        f"{k} output {e:.3g}, batch-norm state {se:.3g} (of max(1, |state|)), card {ms:.3f} ms"
        for k, (e, se, ms) in errs.items()) + f"; bound {UNET_TOL:g}")
    for k, (e, se, _) in errs.items():
        check(e <= UNET_TOL and se <= UNET_TOL, f"UNet {k}: card vs CPU {e}, state {se}")
    part("UNet")

    # ---- the toy GAN through GanTrainer on the card
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.engine.gan import GanTrainer

    gcfg = get_cfg()  # tests/test_gan_trainer.py's settings
    gcfg.GAN_MODE_ON, gcfg.LOSS.GAN.MODE, gcfg.SEED = True, "lsgan", 1
    gcfg.TPU.COMPUTE_DTYPE = "float32"
    sol = gcfg.SOLVER
    sol.OPTIMIZER_NAME, sol.LR_G, sol.LR_D = "adam", 1e-2, 2e-2
    sol.ADAM.BETA2_G = sol.ADAM.BETA2_D = 0.999
    sol.SUPERVISED_MAX_ITER, sol.D_UPDATE_RATIO, sol.D_INIT_ITERS = 5, 2, 7
    target = np.array([2.0, -1.0], np.float32)

    def loader():
        r = np.random.default_rng(0)
        while True:
            yield {"x": (r.standard_normal((64, 2)) * 0.3 + target).astype(np.float32)}

    tr = GanTrainer(gcfg, loader(), model=_ToyGan(gcfg), device="cuda")
    z = torch.randn(512, 4, generator=torch.Generator().manual_seed(123)).cuda()

    def dist():
        with torch.no_grad():
            return float(np.linalg.norm(tr.model.gen_samples(tr.state.params, z).mean(0).cpu()
                                        .numpy() - target))

    d0 = dist()
    t0 = time.perf_counter()
    tr.train(0, GAN_ITERS)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    tr.flush_metrics()
    hists = tr.storage.histories()
    counts = tuple(len(hists[k].values()) for k in ("loss_sup", "loss_d", "loss_g"))
    want = (5, GAN_ITERS - 5, len([i for i in range(5, GAN_ITERS) if i % 2 == 0 and i >= 7]))
    d1 = dist()
    print(f"GanTrainer toy GAN [{card}]: {GAN_ITERS} iterations in {took:.2f} s "
          f"({1e3 * took / GAN_ITERS:.2f} ms each); supervised, D and G steps {counts} (want "
          f"{want}); the sample mean's distance to the target {d0:.4f} -> {d1:.4f}; D on "
          f"{tr.d_params['w1'].device}")
    check(counts == want, f"GanTrainer: steps {counts}, want {want}")
    check(tr.state.step == GAN_ITERS and tr.d_params["w1"].is_cuda,
          f"GanTrainer: step {tr.state.step}, D on {tr.d_params['w1'].device}")
    check(d1 < 0.9 * d0, f"GanTrainer: the toy GAN did not learn ({d0} -> {d1})")
    part("GAN")
    print(f"item 8: part seconds {', '.join(parts)}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# side processes: phases 18 to 22 beside phases 11 to 17
# --------------------------------------------------------------------------
# Phases 18 to 22 share no state with the others, and the host sets their
# pace (Python, process start-ups, loaders, graph captures), not the card.
# Once every phase that times a kernel (3, 6, 7, 10, 13, 16) has run alone,
# they run in two more processes, each of its phases whole and in order,
# beside phases 11 to 17 in the main process, the two groups of about equal
# length (phase 22, 240-330 s, after phase 18; phase 19 after 20 and 21). A side
# process writes its phases' launches and seconds to a file and its output
# to a log, which the main process prints when the side process has ended.
# So the seconds, rates and busy shares that phases 11 to 22 print are taken
# with the card and the host's cores shared; the kernels' times in the last
# lines are not.
SIDE_GROUPS = (("data parallel", "sampler modes"), ("geometries", "tools", "e2e"))
SIDE_PHASES = {"data parallel": phase_data_parallel, "e2e": phase_e2e,
               "geometries": phase_geometries, "tools": phase_tools,
               "sampler modes": phase_sampler_modes}
SIDE_TIMEOUT = 1000  # seconds from its start that a side process may take


class _Side:
    """``python -u chip_smoke.py --side NAMES --out FILE`` in a session of
    its own: it and every process it starts form one process group, killed
    when it has ended (whatever it left behind) or when the main process
    exits first."""

    def __init__(self, names, tmp):
        import atexit

        self.names = names
        stem = os.path.join(tmp, names[0].replace(" ", "_"))
        self.out, self.log_path = stem + ".json", stem + ".log"
        self.log = open(self.log_path, "w")
        self.t0, self.started = time.perf_counter(), time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--side", ",".join(names),
             "--out", self.out], stdout=self.log, stderr=subprocess.STDOUT, cwd=ROOT,
            start_new_session=True)
        atexit.register(self.kill)

    def kill(self):
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()

    def tail(self, n=30):
        with open(self.log_path, errors="replace") as f:
            return "".join(f.readlines()[-n:])

    def check_alive(self):
        """Fails at once where the side process has already failed."""
        rc = self.proc.poll()
        check(rc in (None, 0), f"side process {', '.join(self.names)} exited with {rc}; the "
                               f"end of its log:\n{self.tail()}")

    def join(self):
        """Waits for the side process, prints its log, and returns
        ({phase: result}, {phase: seconds})."""
        try:
            rc = self.proc.wait(timeout=max(1.0, SIDE_TIMEOUT - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            rc = "no code: stopped after its time limit"
        self.kill()
        self.log.close()
        with open(self.log_path, errors="replace") as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        check(rc == 0, f"side process {', '.join(self.names)} exited with {rc}; the end of its "
                       f"log:\n{self.tail()}")
        self.took = os.path.getmtime(self.out) - self.started
        with open(self.out) as f:
            res = json.load(f)
        return res["results"], res["seconds"]


def side_main(names, out):
    """A side process: the named phases in order; {"results", "seconds"}
    written to ``out``. Exits on its own when the main process is gone."""
    import signal
    import threading

    sys.path.insert(0, ROOT)
    card = phase_device()
    import lvt_tpu_torch  # noqa: F401  (TF32 off)
    from lvt_tpu_torch.ops._lib import LIBRARY

    LIBRARY.get()  # built by the main process's phase 2: loaded, not built again
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(2)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=orphaned, daemon=True).start()
    results, seconds = {}, {}
    for name in names:
        t0 = time.perf_counter()
        results[name] = SIDE_PHASES[name](card)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"side process: {name} {seconds[name]} s", flush=True)
    with open(out + ".part", "w") as f:
        json.dump({"results": results, "seconds": seconds}, f, default=int)
    os.replace(out + ".part", out)


def main():
    if "--side" in sys.argv:  # a side process, started by main() below
        args = sys.argv[sys.argv.index("--side") + 1:]
        side_main(args[0].split(","), args[args.index("--out") + 1])
        return
    start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "lvt_tpu_torch")):
        fail(f"no lvt_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    card = phase_device()
    import lvt_tpu_torch  # noqa: F401  (TF32 off)

    laps, last = [], [time.perf_counter()]

    sides = []  # the side processes, once started

    def lap(name):  # host seconds of each phase, printed at the end
        now = time.perf_counter()
        laps.append(f"{name} {now - last[0]:.1f}")
        last[0] = now
        for s in sides:
            s.check_alive()

    phase_build()
    lap("build")
    # the phases that time kernels, alone on the card (see SIDE_GROUPS)
    kres = phase_kernels(card)
    lap("kernels")
    i8res = phase_i8_kernels(card, kres["decode_attention"]["ms"])
    lap("i8 kernels")
    fold_err = phase_i8_fold(card)
    lap("i8 fold")
    for k, name in ((3, "decode_attention_i8"), (4, "decode_attention_i8_live")):
        i8res[name]["err"] = max(i8res[name]["err"], fold_err[k])
    k10, err1_train, _ = phase_train_kernels(card)
    shapes = phase_attention_shapes(card)
    k10["err"] = max(k10["err"], shapes["bwd"], shapes["dbias"])
    lap("train kernels")
    fres, fbounds = phase_fused_kernels(card)
    lap("fused kernels")
    k12, k12_launches = phase_probe_kernel(card)
    lap("probe kernel")
    launches, models, codes = phase_main(card)
    lap("main")
    phase_agree(card)
    lap("agree")
    phase_pth(card)
    lap("pth")
    k6 = phase_vq_kernel(card, models)
    lap("vq kernel")
    phase_ctx_encode(card)
    lap("ctx encode")

    # phases 18 to 22 in two side processes from here on
    import atexit
    import shutil
    import tempfile

    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    atexit.register(shutil.rmtree, keep, True)
    torch.cuda.empty_cache()
    sides.extend(_Side(names, keep) for names in SIDE_GROUPS)
    print(f"side processes started after {time.perf_counter() - start:.1f} s: "
          + "; ".join(", ".join(s.names) for s in sides), flush=True)

    i8_launches, vts = phase_main_i8(card, models)
    lap("main i8")
    phase_slices(card, models, codes, modes=SLICE_PROFILED, vts=vts)
    lap("slices")
    phase_agree_i8(card)
    lap("agree i8")
    phase_bench_slice(card, models)
    lap("bench slice")
    del models, codes, vts
    # phases 8 and 14 hand their OUTPUT_DIRs on to phase 17
    vt_dir, vq_dir = os.path.join(keep, "dsfvt"), os.path.join(keep, "prdvqvae2")
    fused_run, unfused_run = phase_train(card, keep=vt_dir)
    lap("train")
    phase_train_agree(card)
    lap("train agree")
    vq_run = phase_vqvae_train(card, keep=vq_dir)
    lap("vqvae train")
    phase_vqvae_agree(card)
    lap("vqvae agree")
    eval_launches = phase_eval(card, vq_dir, vt_dir)
    lap("eval")
    phase_item8(card)
    lap("item 8")
    main_done = time.perf_counter() - start
    side = {}
    for s in sides:
        results, seconds = s.join()
        side.update(results)
        laps.extend(f"{name} {sec:.1f} (side)" for name, sec in seconds.items())
    dp_launches = side["data parallel"]
    tp_launches = dp_launches.pop("tp")
    e2e_launches, geo_launches, tool_launches = side["e2e"], side["geometries"], side["tools"]
    modes_launches = side["sampler modes"]
    print(f"main process's phases done after {main_done:.1f} s; side processes, from their "
          "start to their result: " + "; ".join(f"{', '.join(s.names)} {s.took:.1f} s"
                                                for s in sides))
    print("phase seconds: " + ", ".join(laps) + f"; whole run {time.perf_counter() - start:.1f} s")

    def entry(name, source, replaces, n_launches, r):
        keys = ("err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                **{k: v for k, v in r.items() if k not in keys}}

    def fused_entry(name, k, replaces, n_launches):
        # bf16, not causal (the encoder's layers), at nb=64; no single library
        # call computes a fused layer: the unfused layer's times stand beside
        t = fres[("bfloat16", False)]
        e = entry(name, "lvt_tpu_torch/csrc/fused_layer.cu", replaces, n_launches,
                  {"err": max(fres["float32"][k], fres["bfloat16"][k]), "ms": t[k][0],
                   "plain_ms": t[k][1], "bound_ms": fbounds[k][0], "bound_by": fbounds[k][1],
                   "library_ms": None})
        e["unfused_layer_ms"] = t["unfused_fwd"] if k == 7 else t["fb_unfused"]
        e["by_function_ms"] = (fres["by_function"] or {}).get(k)
        return e

    kres["block_attention_fwd"]["err"] = max(kres["block_attention_fwd"]["err"], err1_train,
                                             shapes["fwd"])
    kernels = [
        entry("block_attention_fwd", "lvt_tpu_torch/csrc/block_attention.cuh",
              "lvt_tpu/ops/attention.py:127", launches[0], kres["block_attention_fwd"]),
        entry("decode_attention", "lvt_tpu_torch/csrc/decode_attention.cu",
              "lvt_tpu/ops/cache_attention.py:451", launches[1], kres["decode_attention"]),
        entry("block_attention_bwd", "lvt_tpu_torch/csrc/block_attention_bwd.cuh",
              "lvt_tpu/ops/attention.py:186", unfused_run["launches"][1], k10),
        fused_entry("fused_layer_fwd", 7, "lvt_tpu/ops/fused_layer.py:74",
                    fused_run["launches"][2]),
        fused_entry("ffn_half_bwd", 8, "lvt_tpu/ops/fused_layer.py:183",
                    fused_run["launches"][3]),
        fused_entry("attn_half_bwd", 9, "lvt_tpu/ops/fused_layer.py:281",
                    fused_run["launches"][4]),
        entry("decode_attention_i8", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
              "lvt_tpu/ops/cache_attention.py:147", i8_launches[0], i8res["decode_attention_i8"]),
        entry("decode_attention_i8_live", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
              "lvt_tpu/ops/cache_attention.py:278", i8_launches[1],
              i8res["decode_attention_i8_live"]),
        entry("matmul_i8w", "lvt_tpu_torch/csrc/matmul_i8w.cu",
              "lvt_tpu/ops/quant_matmul.py:58", i8_launches[2], i8res["matmul_i8w"]),
        # kernel 5 is on no path of the sampler (in the JAX package only a test
        # calls it): held against its plain version in phase 10, launches 0
        dict(entry("cache_attention_i8", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
                   "lvt_tpu/ops/cache_attention.py:35", 0, i8res["cache_attention_i8"]),
             on_main_path=False),
        # kernel 6: the launches of the VQ-VAE training run (1 per step);
        # max_abs_err counts indices that differ from the plain version's, all
        # of them verified near-ties
        entry("nearest_indices", "lvt_tpu_torch/csrc/nearest_indices.cu",
              "lvt_tpu/ops/vq.py:91", vq_run["launches"], k6),
        # kernel 12 is a tool's kernel, on no path of the sampler: the
        # launches are those of the tool's own timing run
        dict(entry("decode_attention_i8kv", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
                   "tools/probe_decode_kernel.py:49", k12_launches, k12), on_main_path=False),
    ]
    for k in kernels:  # phase 17's launches: the evaluation path, apart from the main path's
        k["eval_launches"] = eval_launches.get(k["name"], 0)
        # phase 18's, per rank of each world ("gloo2": two ranks on the card)
        k["dp_launches"] = {w: c[k["name"]] for w, c in dp_launches.items() if k["name"] in c}
        # phase 18's tensor-parallel world (data 1 x model 2), per rank; and
        # phase 3's check at one rank's shard shapes
        if k["name"] in tp_launches:
            k["tp_launches"] = tp_launches[k["name"]]
        if k["name"] in kres["tp_shard"]:
            k["tp_shard"] = kres["tp_shard"][k["name"]]
        # phase 19's, per run: each e2e mode (kernel 6's check apart), generate --img-size
        k["e2e_launches"] = {r: c[k["name"]] for r, c in e2e_launches.items() if k["name"] in c}
        # phase 20's, per run: DSSVT and DSTSVT rollouts, exactness, training;
        # Base-VQVAE; bench_train_torch
        k["geometry_launches"] = {r: c[k["name"]] for r, c in geo_launches.items()
                                  if k["name"] in c}
        # phase 21's, per run: quality_int8, mfu's five runs, the resumed soak
        # child, the profiler hook's three steps
        k["tools_launches"] = {r: c[k["name"]] for r, c in tool_launches.items()
                               if k["name"] in c}
        # phase 22's, per run: the streams and int4 rollouts (one slice each),
        # the temperature rollout, the fp32 teacher passes
        k["sampler_modes_launches"] = {r: c[k["name"]] for r, c in modes_launches.items()
                                       if k["name"] in c}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
