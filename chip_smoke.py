#!/usr/bin/env python3
"""Drive the PyTorch port's zero-shot serving paths (ResNet-50 and ViT-B/16),
its phase-A train step, its split-q/k/v attention entry point, the chain
pretrain -> adapter (phase B), the fp32 parity mode, the evaluation from
files, the command line, its HTTP server, its multi-view training, its ViT
training and LoRA, Grad-CAM and attention rollout, and its exported programs
once on one CUDA GPU, and its data, tensor, sequence and expert parallelism,
its MoE text tower and its serving over every card of the host, its
pipeline parallelism (phases 15 to 18; one card is enough), and its
rematerialization, bf16 attention probabilities and every command over a
group (phase 19).

Run from the root of a checkout:  python3 chip_smoke.py

``python3 chip_smoke.py --first-step-seeds 0 1 2 3 4 5 6 7`` only builds
the kernels and prints the readings behind phase 10's own bounds
(first_step_sweep), and checks nothing; ``--train-first-step-seeds`` does
the same for phase 11's (train_first_step_sweep), and ``--gradcam-seeds``
for phase 13's gradcam bounds (gradcam_sweep).

Phases (any failure exits non-zero and prints no result line):

0. Card: name and power limit from nvidia-smi. Without CUDA, exit at once.
   Then the host probe: g++ (which builds the JPEG, BMP, TIFF and Netpbm
   decoder on zlib), libpng's, zlib's and libjpeg's headers,
   -lpng16 / -lpng / -lz / -ljpeg at link time, which of safetensors,
   PIL, scikit-learn, pandas and cv2 are installed (the port imports none of
   them), and whether matplotlib is (the plots of gradcam and rollout
   import it).
1. Build: compile the port's kernels (clip_for_dl_tpu_torch/csrc/*.cu) with
   nvcc for sm_90a, one nvcc per source, all at once; print the build time,
   ptxas' per-kernel summary and, from cuobjdump's SASS of the library, the
   tensor-core instructions (HMMA, HGMMA) of each attention kernel (the
   forward, and the backward's rows and columns pass, at D = 32, 64 and 128
   and in the sliced form over 128; fails if one has none), the HGMMA of
   B8's kernels (B8a in both GELU forms; fails if one has none) and the
   HGMMA and HMMA of
   the GEMM pair of B4 and of B9 (mlp_fwd_gelu_kernel, mlp_fwd_out_kernel;
   fails at no HGMMA or any HMMA).
2. Kernels: each of B1-B9 against its plain PyTorch version on the card at
   the main paths' shapes (B3 also with dropout 0.1 at the train shape, its
   dropout mask compared bit for bit, and at the ViT shape; B6 at rates 0
   and 0.1; B9 with exact and tanh GELU and at one request's 197 rows); then
   the widths ROADMAP C1-C3 repaired: B3 and B6 at head dim 128 and N = 512,
   B4 and B8 at hidden 256; then the split form: B5 and B7 at the BERT shape
   (128, 200, 12, 64) in both layouts at rates 0 and 0.1 (dropout masks bit
   for bit), bit-equal to B3 and B6 on the same heads, and at D = 128,
   N = 512; the split entry point with autograd (the split_attention path);
   and the layout probe P1 (tools/probe_bwd_layouts.py: B6, B7 "bnhd" and B7
   "bhnd" bit-equal; the layout_probe path); then the limits ROADMAP C4-C6
   lifted: B3/B5/B6/B7 at head dim 32 (built) and 96 (zero-padded to 128)
   against their plain versions (B5/B7 bit-equal to B3/B6), B1 at D = 64
   and 96 with C = 200 prompts, and B2, B3 and B6 at a batch of 65537; and
   head dims over 128 (C4 closed): B3/B5/B6/B7 at D = 160, 256 and 320,
   rates 0 and 0.1, B5/B7 bit-equal to B3/B6, the dropout masks bit for
   bit. B2 also runs at one request ([1, 224, 224, 3]), and is timed with
   its device time (torch.profiler), its GB/s and a Tensor.copy_ of its
   output's size beside it; B1 beside one F.cosine_similarity call (its
   library_ms). B8 is also timed beside its three products alone in cuBLAS (a
   yardstick the port never calls), B4 and B9 beside their two, each with
   its kernels' device times from torch.profiler; B4, B8 and B9 are held at
   H = 1280 (F = 5120) and H = 192 (F = 768). B4 and B8 with the tanh GELU
   (the ViT's --fast-gelu; rows mlp_tanh, mlp_bwd_tanh) at the ViT train
   shape, [25216, 768] x 3072 (B = 128 x 197 tokens), at the erf rows'
   tolerances, with their products in cuBLAS beside them.
   Max abs/rel difference against
   the tolerance below (B6 and B7 per (batch row, head) slice of each
   gradient), both times the median of five CUDA-event timings after
   warm-up, the bound (the larger of the bytes each call must move over
   3.35 TB/s and its operations over the dense peak of their type), and for
   attention the time of F.scaled_dot_product_attention (forward, or its
   backward) on contiguous head-major copies of the same inputs at rate 0,
   with the backend it picked. Shapes off the kernels line (other rates,
   layouts and widths) print the same figures.
3. Slice: the full-width CXRClip (ResNet-50, BERT-base at vocab 28996,
   512-d heads; random weights from --seed) in bf16 with flash attention and
   the fused BERT MLP, wrapped in ZeroShotEngine: prompt bank ("prediction"
   family, the synthetic dev vocabulary, 200 tokens), batches of 512x512
   grey uint8 images through probs and stream_logits, single 224x224x3
   requests through ZeroShotService.predict_one. Checks shapes, finite
   probabilities in [0, 1], service answers equal to engine.probs, every
   kernel launched by the main path, and the engine's probabilities against
   the same model with each kernel replaced by its plain version. Prints
   img/s.
4. Train: the ``pretrain_clip`` preset at full width (flash attention and the
   fused MLP on, dropout 0.1) with fp32 master weights and bf16 compute,
   random weights from --seed, through ``make_clip_pretrain_step``: first one
   step with dropout 0 against the same step with every kernel (forward and
   backward) replaced by its plain version, from the same weights (loss and
   per-group gradient cosine); then TRAIN_STEPS steps on one batch of
   TRAIN_BATCH 512x512 grey uint8 images and 200-token reports of mixed
   lengths, each synced and timed, and one eval step. Checks finite, falling
   losses, every parameter group and the BatchNorm statistics moved, and
   B2, B3, B4, B6 and B8 launched by the train path. Prints samples/s and
   the peak device memory.
5. ViT slice: phase 3 over the ``vit`` preset's model (ViT-B/16 at 224,
   patch 16, 12 x 768, 12 heads, MLP 3072, and the same BERT-base) with the
   fused ViT MLP block (B9), flash attention in both towers and the fused
   BERT MLP, bf16, random weights from --seed; the same checks, B9 among the
   kernels the path must launch.
6. Chain: phase A, the ``pretrain_clip`` model of phase 4 through ``fit``
   for one epoch of CHAIN_STEPS steps at TRAIN_BATCH with a one-batch
   validation and a CheckpointManager in a temporary directory (the
   pretrain_fit path); then phase B, ``restore_variables`` of that epoch into
   the ``adapter`` preset's model and ``fit`` with the adapter steps for 2
   epochs of CHAIN_STEPS steps on one fixed batch with 16-label multi-hot
   targets from --seed, eval each epoch and best-1 retention, a
   PreemptionGuard triggered after step 2 of a third epoch (the adapter
   path). Checks the towers and BatchNorm statistics bit-equal, the adapter
   moved, finite losses falling on the fixed batch, the retained epoch the
   best by val loss, the preemption slot, ``resume_or_init`` bit-equal at
   the JAX rule's epoch, a finite macro AUROC from ``run_eval``'s
   probabilities, and B2 launched. Prints adapter samples/s, checkpoint save
   ms and the peak device memory.

Phase 2 also holds ROADMAP C7 and C8: the fp32 and fp16 instances of
B3/B5/B6/B7 at head dims 32, 64, 128 and 160 and N = 512, rates 0 and 0.1
(fp32 within 1e-5, gradients within 1e-4 of each slice's largest entry;
fp16 two fp16 steps; masks bit for bit; split bit-equal to packed), timed
beside SDPA in their type, and the autograd entry points in fp16 and fp32
split (path typed_attention); B1 on bf16, fp16 and mixed features, B2 on
fp32 and bf16 images, writing fp16 and fp64, on rows too wide to stage
(the direct body, bit-equal to the staged one) and on views (path
c8_cases).
7. Parity mode (the JAX CLI's --fp32 --flash-attention): the ``zero_shot``
   model in fp32 encodes the prompt bank and scores a batch through the fp32
   attention kernels, and one fp32 phase-A step of ``pretrain_clip`` at its
   B = 16, each against the same model on the plain route (B2 kept): text
   features and probabilities within 1e-5, the loss within 1e-5 relative,
   each group's gradient cosine >= 0.9999.
8. Evaluation from files (the evaluation half of the JAX CLI's zeroshot, as
   library calls; after phase 7, over phase 6's checkpoints): the Kaggle
   layout written by testing/kaggle.py (EVAL_UIDS uids, grey 8-bit PNGs at
   EVAL_SIZES with random row filters, one exam with one view, one file not
   a PNG, some empty findings) -> prepare_labeled_csv, merge_image_report,
   split_by_uid, build_exam_index -> build_image_cache (grey-packed, 224) ->
   ChestXrayMultiViewDataset -> HostLoader (EVAL_BATCH exams a batch). The
   zero_shot model at full width (flash attention, fused BERT MLP, bf16)
   from phase 6's phase-A checkpoint directory, and from a reference .pth
   and a .safetensors mirror the port writes of the same weights: logits
   bit-equal. Then (the eval_files path, counted) the prompt bank,
   run_zero_shot_eval, run_dynamic_threshold_eval and an InferenceSession
   batch; AdapterEngine over phase 6's adapter checkpoint (the eval_adapter
   path). B2 on a cache batch against its plain version, and B1 at the
   engine's and the session's inputs, each tolerance below the spread of
   the outputs between inputs (apart); then the route against the plain one
   from the same weights and batches: the image half (unit and fused
   features, AdapterEngine's logits) below its spread too, the text half
   (unit text features) and the whole route (logits and probabilities of
   every view and of InferenceSession) within their tolerances, spreads
   printed; the prediction sets equal on every exam (top-k) and (exam,
   class) pair (dynamic thresholds) decided further from its edge than the
   routes' measured difference, those so decided counted. Prints
   the cache build img/s, loader batches/s and eval img/s (over EVAL_PASSES
   passes), the decode's stages in one thread and in 8
   (tools/decode_threads.py), and the phase's time.
9. The command line (ROADMAP A4b-2, A5): ``cli.main.main(argv)`` in this
   process on phase 8's layout, at the presets' full width and B = 16, with
   stand-ins from tools/day_one.py (a vocab of the layout's reports padded
   to 28996 entries, the preset's vocab_size; tower files from seeded port
   modules): prep, cache-images, pretrain (--flash-attention
   --bert-fused-mlp --device-cache --bucket-text --length-grouped, the tower
   files, one epoch), adapter, zeroshot and zeroshot --dynamic, eval
   (--bootstrap) and eval --head adapter, convert to .pth and .safetensors,
   each command's launches counted on its cli path. Checks eval on the
   adapter's directory, .pth and .safetensors byte-equal; zeroshot and eval
   --head adapter with --device-cache bit-equal to the streamed feed, every
   gathered batch reaching the model as the same CUDA tensor; zeroshot
   --preset vit --fused-mlp (B9); then zeroshot against itself on the plain
   route, phase 8's split: B2 and B1 at the command's inputs and the image
   half bound below their spreads, the text half and the whole route
   printed with theirs; B3, B6, B4 and B8 at the first inputs pretrain
   gave them (dropout 0.1, a bucketed length), B3 and B4 at the prompt
   bank's and B3 and B9 at the ViT tower's, each against its plain version
   at its phase-2 tolerance; and pretrain's first step from the weights it
   started from against the plain route, as in phase 4. Prints each
   command's wall time, pretrain and
   adapter samples/s (steps synced) and checkpoint save ms, the cache build
   img/s and zeroshot views/s.
10. The server, the report-built prompts and the rest of the pretrain
   options (ROADMAP A2b, A3b) on phase 9's layout, vocab, adapter directory
   and thresholds.json: ``python -m clip_for_dl_tpu_torch serve`` in a child
   process (the zero_shot preset at full width, bf16, --thresholds, the
   default buckets, --max-pending 8; its launches written by the child at
   exit): /healthz, SERVE_PNGS layout PNGs sent one by one, then
   SERVE_CLIENTS clients of SERVE_PER_CLIENT requests each, raw and JSON
   mixed; a garbage and a WebP-headed body (400, the latter naming A2c), unknown
   routes (404); /stats counting every request; SIGINT, exit 0. Every
   answer's probabilities against the plain route on its decoded image
   (5e-3) and the decided predictions equal; requests/s, client and server
   p50/p99, the decode's ms a request and the card's busy share (nvidia-smi
   at 100 ms). Then ``serve --head adapter --buckets 1 --max-pending 8``:
   8 answers against AdapterEngine on the plain route, and BURST clients at
   once (at least one 429 with Retry-After: 1). Then the findings and rich
   banks from the layout's reports through the kernels, against the plain
   route (4e-3). Then ``pretrain --loss siglip --learnable-temperature
   --ema-decay 0.999 --bf16-moments --device-cache`` (one epoch, B = 16) and
   ``pretrain --loss info_nce --learnable-temperature`` (64 synthetic
   pairs): logit_scale at most log 100 after every step, exp_avg half the
   bytes of the fp32 run's, B3, B6, B4 and B8 at each run's first inputs;
   the step's parts timed (step_split: the optimizer, the loss, the EMA);
   each run's first step against the plain route and on the fp32 route
   (a3b_first_step): the loss within 1e-3 relative and each group's
   gradient cosine at least 0.999, but info_nce's loss (2e-2) and its
   projectors' and text tower's cosines (0.995), whose own bounds come from
   the readings of --first-step-seeds and are borne out on the fp32 route;
   each calibration scalar's gradient within 1e-4 + 1e-2 relative; one
   step from logit_scale = log 200 ends at log 100. Samples/s, peak memory
   and the EMA update's ms. Last ``eval --use-ema`` and
   ``convert --use-ema``: the converted .pth scores byte-equal to the slot,
   and --use-ema on a directory without one raises.
11. The scripts' multi-view training, its cross-modal attention variant and
   the shared-embedding adapter (ROADMAP A6, A8) on phase 9's layout, vocab,
   tower files and pretrain directory, in this process, at full width
   (ResNet-50, BERT-base, shared 512, bf16, --flash-attention
   --bert-fused-mlp --device-cache): ``train --preset scripts_train`` and
   ``train --preset multimodal_attention`` (three epochs of four steps at
   B = 32 exams, the preset's augmentation and cosine schedule, a
   checkpoint directory), ``zeroshot --preset multimodal_attention
   --dynamic`` on the latter's directory, and ``shared-adapter`` (one
   epoch at B = 16 from phase 9's pretrain directory). Checks B2 launched
   once a step and an evaluation batch, B3 and B4 twelve times a bank
   encode; B2 at the first step's input and B3, B4 at the 512-token bank's
   first inputs against their plain versions; each run's first step, from
   the weights it started from, B2's output shared and the same
   augmentation draw, against the plain route (each route encodes its own
   bank): the bank's unit text features within 4e-3 (the bf16 guard on B3
   and B4 there), the loss within 3e-3 (scripts_train) and 5e-3
   (multimodal_attention) relative, bounds from the readings of
   --train-first-step-seeds alone, each group's gradient cosine at least
   0.999, and on the fp32 route the kernels' fp32 instances (bank 1e-5,
   loss 1e-5, cosines 0.9999); the last checkpoint restoring the weights,
   BatchNorm statistics and AdamW moments bit for bit; nothing of a run
   left on the device after it (64 MiB); the multimodal zero-shot's B1 and
   B2 at their first inputs, its probabilities against the plain route
   (5e-3), and both runs' prediction sets under their own thresholds.json
   equal on the (exam, class) pairs decided by more than that; the shared
   adapter's B3 and B4 at the reports' first inputs, only its head moved,
   finite metrics. Prints exams/s and images/s over steps 1 on (each step
   synced) with the median and range of the step, the step's parts (prep,
   augment, towers, loss, backward, clip, optimizer; synced at their
   bounds, step_split), the bank encode's ms at 512 tokens, the saves' ms,
   each command's peak memory and wall time.
   Then tools/launch_times.py times the wrappers from the host.

12. ViT training and LoRA (ROADMAP A8), after phase 11, on phase 9's
   layout, vocab, BERT file and pretrain directory. First the ``vit``
   preset's step at B = 128 (ViT-B/16 + BERT-base, 200 tokens, bf16,
   --flash-attention --bert-fused-mlp --vit-fused-mlp-train, dropout 0)
   with the exact and with the tanh GELU: one step with the kernels against
   one with their plain versions from the same weights (phase 4's bounds),
   then 11 synced steps (samples/s over the last 10, peak memory; paths
   vit_train, vit_train_tanh). Then the command line: ``pretrain --preset
   vit --fast-gelu --flash-attention --bert-fused-mlp --vit-fused-mlp-train``
   (two epochs), ``pretrain --lora 8`` (ResNet-50, from phase 9's pretrain
   directory), ``pretrain --preset vit --lora 8 --fused-mlp
   --flash-attention`` (from the ViT run's directory) and ``zeroshot
   --checkpoint <dir>/folded`` for each LoRA run: each run's first step
   against the plain route (phase 4's bounds), each folded model against
   the merged one bit for bit (features and zero-shot probabilities), each
   command's wall time, samples/s over its steps after the first, peak
   memory and what it leaves on the device (at most 64 MiB).

13. Interpretability (ROADMAP A9), after phase 12. The library half: the
   zero_shot model (ResNet-50 + BERT-base, bf16, flash attention and the
   fused BERT MLP, random weights from --seed) encodes the "prediction"
   bank and runs ``interpret.gradcam`` on two 512x512 grey views prepared to
   fp32 by B2 (path gradcam: B2, B3, B4): B2 at its input within 1e-4 of
   its plain version; the same call with the same text features and B2 on
   its plain version, in bf16 and on the model's fp32 twin: the bf16
   kernels from the fp32 route within 8e-2 (scores, of the largest) and
   0.25 (CAMs), the fp32 scores within 2e-3 of the largest (TOL says why
   the bf16 routes are not held to 1e-3, and that these bounds only
   witness the path); the batched backward bit-equal to 16 single ones;
   the bank against the plain route (4e-3).
   The vit model (ViT-B/16 at 224, bf16, --fused-mlp, flash attention on)
   through ``interpret.vit_rollout`` on the same views (path rollout: B2
   and B9, and B3 never: sowing turns flash off), its mask against the
   plain route (max |difference| 2e-2, cosine 0.999: a witness of the
   path only, as the mask is nearly flat on random weights), and the
   sowing forward's features bit-equal to the forward with flash off. Then
   ``gradcam --synthetic --flash-attention --bert-fused-mlp`` and
   ``rollout --synthetic --fused-mlp --flash-attention --discard-ratio 0.1``
   at full width (paths cli_gradcam, cli_rollout): the JAX commands' file
   names and count; where matplotlib is missing, each overlay is recorded
   (name, shape, range) in place of its drawing, and that is printed. On
   all four paths each kernel is held at its first inputs against its
   plain version at its phase-2 tolerance (B2 to fp32 within 1e-4, B3 and
   B4 within 2e-2, B9 within 2^-6 of its branch's largest entry): that is
   the guard of the kernels here. Prints each call's time.

14. Export (ROADMAP A9b), after phase 13, on phase 9's files.
   ``tools/export_inference --checkpoint <phase 9's adapter directory>
   --stablehlo --dtype bfloat16 --source-size 512 --cpu`` at full width
   (the zero_shot model, folded), in this process: the four programs
   traced on the CPU, the folded weights and the manifest, with the
   export time and the files' sizes. ``serve --exported`` in a child
   process, and again with ``--head adapter`` (paths export_serve,
   export_serve_adapter: B1 and B2, B2), each sent EXPORT_ALONE 512x512x3
   PNGs one at a time and EXPORT_CLIENTS x EXPORT_PER_CLIENT at once: every
   answer held against the live engine on the card (the tool's folded
   weights, ``load_folded_model``, and the bank baked into score_image.pt2)
   at the bucket it ran in, probabilities within 1e-6; the request rates and
   the load times. In this process both programs against the live engines
   at b = 1, 3 and 16, logits within 1e-5 (path export_programs), and the
   folded against the unfolded bf16 model printed as a reading. Then, on
   the card, ``export_text_encoder`` of the zero_shot model with flash
   attention and the fused BERT MLP (L = 200; path export_text: B3, B4)
   and ``export_singleview_scorer`` of the fused-MLP ViT-B/16 at 512x512
   input (path export_vit: B1, B2, B3, B9), each against its live forward
   within 1e-5. On every path each kernel is held at its first inputs
   against its plain version (hold_first_inputs, phase-2 tolerances).

15. Data parallelism (ROADMAP A7), after phase 14, on phase 9's files.
   ``python -m torch.distributed.run --standalone --nproc-per-node <cards>
   chip_smoke.py --phase15-rank DIR``: each rank joins the NCCL group on
   its card, prints (rank 0) the world size and NCCL's version, and runs
   (a) the phase-A step (ResNet-50 + BERT-base, 200 tokens, dropout 0) at a
   global batch of 128 through parallel.dp against the single-device step
   on the whole batch, three steps of each from the same weights, on the
   fp32 route (the first step's loss 1e-5 rel, each group's gradient
   cosine 0.9999) and in bf16 (2% and 0.99), but where BatchNorm's
   arithmetic reaches, at TOL["dp_bn"], which a planted fault (BatchNorm
   statistics of each half of the batch) must fail; both routes timed
   (samples/s);
   (b) on the fp32 route the local-loss form of clip_self_distill and
   siglip's ring against their all-gather forms (1e-5, 0.9999); (c)
   GradCache on the ViT-B/16 step (4 microbatches, LayerNorm only) against
   the full batch of 128 (2%, 0.99), and its peak above the resident state
   below the full step's; (d) ``pretrain --accum-steps 2`` over the group
   (two steps of 16 synthetic pairs at full width, phase 9's vocabulary, a
   checkpoint) and ``zeroshot`` of that checkpoint on phase 9's files. Each
   path holds its kernels (B2, B3, B6, and on the bf16 paths B4, B8; B1
   in zeroshot) at their first inputs, the fp32 instances at their type's
   rule; each rank's launches count as path@rankN; ranks other than 0 must
   write no file. Then, in this process, a single-device ``zeroshot`` of
   the group's checkpoint: probabilities within 5e-3 of the group's, and
   the same command scoring each rank's share of every batch apart: the
   group's logits bit for bit (each rank scored a smaller batch). The
   data-parallel steps take BatchNorm's statistics through the group at
   every world size, one card included (models/resnet.py _global_bn).
16. Tensor and sequence parallelism, serving over a group (ROADMAP A7b),
   after phase 15, on phase 9's files. (a) On this card: B3 and B6 with
   dropout 0.1 at the train shape on each rank's heads at tp 2 and 4
   (``head_offset``) bit for bit the unsharded kernel's heads, their masks
   bit for bit the plain version's on the probe, offset 0 bit for bit the
   call without it; B3/B6 at 6 and 3 heads and B4/B8 at F 1536 and 768
   against their plain versions and timed beside their bounds, SDPA and
   cuBLAS; every rank's share of a full-width BERT-base layer (dropout 0.1)
   and ViT-B/16 layer, forward and backward, run one after another and
   summed here, against the unsharded layer (TOL tp_layer_rel,
   tp_grad_cos), the kernels held at the shares' first inputs. (b)
   ``torchrun --nproc-per-node <cards> chip_smoke.py --phase16-rank DIR``:
   in each rank over NCCL the zero-shot engine data-parallel and at each tp
   degree (at one card the TP layers' own path, bit for bit the plain
   engine) against the single-device engine, with the bank's ms, images/s
   and peak memory; the phase-A step through tensor_parallel_step (fp32
   route against one card at TOL dp_bn fp32, shards gathered; the bf16 step
   against the data-parallel step over the same data group at
   train_loss_rel); sequence_sharded_fn replicated and with tp_params
   against the tower's
   forward (eval_text_features; at one card replicated bit for bit); and
   ``zeroshot --num-devices <cards> --tp <t>``. (c) ``serve --num-devices
   <cards>`` under torchrun with --tp (zero_shot preset, phase 9's adapter
   checkpoint) and the ViT-B/16 preset with --fused-mlp (B9 on each rank's
   data slice): concurrent requests answered, SIGTERM stops every rank
   (rank 0 broadcasts the stop, each follower reports it); every rank's
   launches count as path@rankN.
17. The Switch-MoE text tower, routing over a group, expert parallelism
   (ROADMAP A7b items 1-2), after phase 16, on phase 9's files. (a) On this
   card: one MoE layer at BERT-base width (768 -> 3072, 8 experts,
   capacity 1.25) on 128 reports of 200 tokens with their real padding,
   the bf16 layer against its fp32 route (TOL moe_bf16_rel); each expert
   product against the fp32 product of its operands (TOL moe_product_rel)
   and its experts before the final cast against fp32 on its bf16
   operands (TOL moe_products_rel), which a planted fault (products
   rounded to bf16) must fail; every ep share (2, 4, 8) run one after another and summed,
   against the unsharded layer: the output, the aux loss and every
   gradient bit for bit; the time of one batched product over the experts
   and of a product an expert; the tokens routed and dropped by each
   expert, the aux loss. (b) pretrain_clip's step with the MoE text tower
   at B = 128: the first step against the plain route (train_loss_rel,
   grad_cos); 10 synced steps (path moe_train), samples/s and peak memory
   beside phase 4's and beside the same step with a product an expert, the
   launches a step (B3 and B6 12, B4 and B8 6), each kernel held at its
   first inputs. (c) ``pretrain --moe-experts 8`` and ``zeroshot
   --moe-experts 8`` of its checkpoint (paths cli_pretrain_moe,
   cli_zeroshot_moe); ``zeroshot`` without the flag refused by the
   missing-tensor guard. (d) ``torchrun --nproc-per-node <cards>
   chip_smoke.py --phase17-rank DIR``: ``pretrain --num-devices <cards>
   --moe-experts 8`` (path cli_dp_pretrain_moe), its first step against
   the single-device step on the global batch (fp32 route, TOL dp_bn
   fp32), its MoE text tower routing over the group against one card (bit
   for bit at world size 1; on the fp32 route at a capacity factor that
   drops tokens, at TOL moe_group_fp32_rel, which per-rank routing,
   planted, must fail);
   with more than one card, ``pretrain --num-devices <cards> --ep 2
   --fp32`` (path cli_ep_pretrain_moe: its feed, its first step against
   one card, its whole checkpoint) and the step through
   ``expert_parallel_step`` at ep 2 and 4 against the data-parallel step
   (fp32 route, TOL dp_bn fp32), and each route's samples/s in bf16
   (paths ep_step_{ep}); every path's kernels held at their first inputs.
18. Pipeline parallelism (ROADMAP A7b item 1), after phase 17, on phase
   9's files. (a) On this card: BERT-base at full width, built with flash
   attention and the fused MLP (which the pipeline ignores), on 128 reports
   of 200 tokens with their real padding: every stage's share at S = 2 and
   4 run one after another (``pipelined_bert_shares``, 4 microbatches),
   forward and backward, against the unpipelined tower on the plain routes
   (fp32 route TOL pp_fp32_rel, bf16 TOL pp_bf16; the output, the stack's
   and every share's embeddings' gradients), no kernel launched; the
   broadcast's summing backward and the embeddings' stage sum left out,
   planted, must each fail. (b) ``torchrun --nproc-per-node <cards>
   chip_smoke.py --phase18-rank DIR``: the phase-A step through
   ``pipeline_parallel_step`` (at one card S = 1, 4 microbatches, no hop;
   with more cards pp 2 and 4) on the fp32 route against the
   data-parallel (one card: the single-card) step at TOL dp_bn fp32, B2
   alone launched (paths pp_step_{S}); with more than one card ``pretrain
   --num-devices <cards> --pp 2 --fp32`` (path cli_pp_pretrain: its first
   step against one card's, TOL pp_command_rel; its whole ``unstacked/``
   checkpoint; no file from ranks other than 0) and each route's bf16
   samples/s and peak memory beside the data-parallel step's. Then
   ``zeroshot`` of the ``unstacked/`` checkpoint (written at one card from
   the S = 1 step's state as the command writes it; path cli_zeroshot_pp);
   every path's kernels held at their first inputs.
19. The last refused flags (ROADMAP A7b item 2, ``--remat``,
   ``--bf16-attention-probs``), after phase 18, on phase 9's files. (a) The
   phase-A step at full width (ResNet-50 + BERT-base, B = 128 x 200, bf16,
   flash attention and the fused MLP), the model built as ``--remat``
   builds it, under each policy (full, dots, dots_no_batch): the first
   step, dropout 0, against the step without remat at phase 4's bounds;
   then REMAT_STEPS steps of each form at the preset's dropout, their
   samples/s and peak memory (full below the step without remat), B3 and
   B4 launched 24 times a step under full, B6 and B8 12 (paths
   remat_train_*). (b) The plain attention route (flash off) with
   ``--bf16-attention-probs`` against it without, first step at phase 4's
   bounds, and both forms' samples/s and peak (the flag's below; path
   bf16_probs_train). (c) ``torchrun --nproc-per-node <cards> chip_smoke.py
   --phase19-rank DIR``: ``eval``, ``gradcam``, ``prep``, ``cache-images``
   and ``convert`` over the group, then alone in this process: the same
   files (byte for byte at one card), nothing from ranks other than 0,
   B1-B4 held at their first inputs; with four cards ``pretrain --ep 2``
   over the processes against ``--num-devices`` (ep_processes19).

20. Image decoding beyond PNG (ROADMAP A2c, C11), after phase 19, on
   phase 8's layout and phase 9's files. cv2 runs in a child process
   (CV2_CHILD), the yardstick the port never calls; the phase fails without
   it or if its JPEG backend is not libjpeg-turbo. (a) The port's decoder
   built with g++ (timed) and held byte-equal to cv2.imdecode on JPEGs cv2
   writes: grey and colour, 4:4:4, 4:2:2, 4:2:0 and 4:1:1, progressive, a
   restart interval, EXIF orientation 6, at 224 square and 2320 x 2828; its
   decode ms beside cv2.imdecode's (median of JPEG_TIMED) at 224 and
   2320 x 2828 grey, baseline and progressive. (b) The layout's files as
   JPEG q95 (JPEG_BIG frontal views at 2320 x 2828) and their PNG twin
   holding cv2's decodes (testing/png.py): cache-images over each at
   --workers 1 and 8 (img/s; the four caches byte-equal), zeroshot over each
   from phase 9's pretrain checkpoint (probabilities bit-equal; paths
   cli_zeroshot_jpeg, cli_zeroshot_twin). (c) ``serve`` in a child process
   over phase 9's adapter checkpoint: JPEG and BMP bodies at 224 x 224 x 3
   and 2048 x 2048 grey, each decode byte-equal to cv2's, each answer within
   1e-6 of this process's engine on the kernels alone on its pixels (below
   the answers' spread over images), within 5e-3 of the plain route and
   bit-equal to its PNG twin's one by one; the bodies' unit image features
   within 1e-5 of the plain route (below their spread); a WebP and a CMYK TIFF body 400 naming A2c; req/s one by one and
   JPEG_SERVE_CLIENTS x JPEG_SERVE_PER_CLIENT, client p50/p99, JPEG bodies
   beside PNG (path cli_serve_jpeg).

21. TIFF and Netpbm decoding (ROADMAP A2c, second part), after phase 20, on
   phase 8's layout and phases 9's and 20's files. cv2 runs in a child
   process (CV2_CHILD, as in phase 20), the yardstick. (a) The decoder
   rebuilt (timed) and held byte-equal to cv2.imdecode and to
   cv2.imread on TIFFs and Netpbm files cv2 writes (16-bit grey LZW and
   Deflate at 2048 square, RGB, RGBA, PackBits, uncompressed; PGM, PPM, PBM,
   PAM), a JPEG TIFF PIL writes, and TIFFs of the port's test writer (tiles
   in big-endian order, BigTIFF with separate planes, the old LZW with a
   palette, Orientation 6); its decode ms beside cv2's (median of
   TIFF_TIMED) at 2048 square. (b) The layout's files as 16-bit grey LZW
   TIFF and binary 16-bit PGM (the high bytes the PNGs' grey): cache-images
   over each byte-equal to phase 9's cache of the PNGs, zeroshot over each
   and over the PNGs from phase 9's pretrain checkpoint (probabilities
   bit-equal; B1-B4 held at the TIFF run's first inputs against their plain
   versions; paths cli_zeroshot_{tiff,pgm,png}21). (c) ``serve`` over phase
   9's adapter checkpoint: 2048-square TIFF and PGM bodies, a 224 TIFF and
   PPM, and phase 20's JPEG and BMP, each answer bit-equal to its PNG
   twin's, within 1e-6 of the engine alone on its pixels and within 5e-3 of
   the plain route, the unit image features within 1e-5 of the plain route;
   a CMYK and a Group 4 TIFF 400 naming A2c, a float TIFF 400 without; req/s
   and client p50/p90 over TIFF_SERVE_ROUNDS requests of each body one by
   one, and TIFF_SERVE_CLIENTS x TIFF_SERVE_PER_CLIENT over the 2048-square
   TIFF and PGM bodies, client p50/p99 (path cli_serve_tiff).

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import copy
import csv
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# Tolerances (max abs difference) of each kernel against its plain version
# on the card, with the reason for each.
TOL = {
    # fp32 in and out, sums in another order; logits are bounded by 1/T = 2
    "similarity": 1e-5,
    # fp32 output: 2-tap lerp vs the dense-matrix matmul, values ≤ 2.2
    "image_prep_f32": 1e-4,
    # bf16 output: a 1e-6 fp32 difference can flip one bf16 rounding step,
    # 2^-7 at values up to 2.2
    "image_prep": 1.6e-2,
    # bf16 output |o| ≤ ~3: summation order may flip the bf16 rounding of a
    # probability or of the output, each ≤ one bf16 step (2^-7 · 2)
    "flash_attention": 2e-2,
    # bf16 output |y| ≲ 2: accumulation order may flip the bf16 rounding of
    # the GELU output or of y, each ≤ one bf16 step
    "mlp": 2e-2,
    # B8, relative to each output's largest entry: two bf16 steps (2^-6);
    # the kernel rounds the same intermediates (g, dh) to bf16 as the plain
    # version, and summation order can flip one rounding of an intermediate
    # and one of the output. B6 and B7 are held the same way per (batch row,
    # head) slice of each gradient (fa.grad_slice_error, in compare_grads)
    "bwd_rel": 2.0 ** -6,
    # B9, on the MLP branch out - x and relative to its largest entry: two
    # bf16 steps (2^-6); a summation-order flip of the GELU or o rounding
    # moves out by one step of o, and the residual's rounding by one step of
    # out, which at x ~ N(0, 1) (|out| < 8) is within one more step of the
    # branch's largest entry (|o| ~ 4)
    "mlp_block_rel": 2.0 ** -6,
    # phase 4, kernels vs plain versions from the same weights and inputs,
    # dropout 0: the cosine of each parameter group's gradient with the
    # plain one, for the backward of one fixed random cotangent on both
    # towers' features and for one whole step (the kernels round the same
    # intermediates as their plain versions; only rounding flips and
    # summation order differ); and the step's loss (≈ 7 at B = 128) within
    # 2%: bf16 features carry ~3 significant digits, and the self-distill
    # loss on raw 512-d features (norm ≈ 22) at T = 2 has logits up to ~20
    "grad_cos": 0.99,
    "train_loss_rel": 2e-2,
    # phase 10, the first step of each pretrain run with a learnable
    # temperature against the plain route: the loss within 1e-3 relative
    # and each group's gradient cosine at least 0.999, but where the loss or
    # a group has its own bound, (loss name, "loss" or group) -> bound. The
    # own bounds come from the readings of `chip_smoke.py --first-step-seeds
    # 0 1 2 3 4 5 6 7` (PERF.md, "The first-step sweep"): info_nce at s = 1/T = 0.5 on raw
    # features differs from the plain route by up to 1.10e-2 in its loss
    # and down to 0.99769 in the projectors' and the text tower's cosines
    # (siglip: 3.0e-4, 0.99949). Each own bound is borne out on the fp32
    # route in every run: there the kernels within fp32_loss_rel and
    # fp32_grad_cos of the plain route, and the kernels' departure from the
    # plain route (relative, or 1 - cosine) no larger than the plain bf16
    # route's own departure from the plain fp32 one (readings: at most 0.31
    # of it for the loss, 0.021 for the gradients)
    "a3b_loss_rel": 1e-3,
    "a3b_grad_cos": 0.999,
    "a3b_own": {("info_nce", "loss"): 2e-2, ("info_nce", "text_tower"): 0.995,
                ("info_nce", "image_projector"): 0.995, ("info_nce", "text_projector"): 0.995},
    # each calibration scalar's gradient (logit_scale, logit_bias) against
    # the plain route's, |kernels - plain| <= atol + rel * |plain|, in the
    # units of the clipped step (the whole gradient's norm at most 1); the
    # readings above differ by 5.4e-7 to 5.47e-5, where a scalar's gradient
    # is 2.0e-4 to 1.0e-2
    "calibration_grad_atol": 1e-4,
    "calibration_grad_rel": 1e-2,
    # phase 11, the first step of each train run against the plain route,
    # B2's output shared and the same augmentation draw: the step runs no
    # kernel but B2, so the routes differ only in the epoch's prompt bank
    # (B3 and B4 in twelve bf16 BERT layers, within eval_text_features):
    # the loss within 1e-3 relative, each group's gradient cosine >= 0.999,
    # but where a preset's loss or group has its own bound, (preset, "loss"
    # or group) -> bound
    "train_first_loss_rel": 1e-3,
    "train_first_grad_cos": 0.999,
    # the own bounds come from the readings of `chip_smoke.py
    # --train-first-step-seeds 0 1 2 3 4 5 6 7` (PERF.md, "PR 15"): the
    # loss departs from the plain route's by up to 7.2e-4 (scripts_train;
    # 1.09e-3 on the layout's images) and 1.91e-3 (multimodal_attention;
    # 2.70e-3 on the layout's images), where the banks differ by 1.96e-3
    # to 2.44e-3 and the logits are cosines over T = 0.07; every cosine
    # stays >= 0.99961. The loss bounds rest on those readings alone: no
    # run can bear them out in bf16 (the kernels' bank lies 0.77 to 1.15
    # times as far from the plain bank as that lies from the fp32 one, and
    # a bf16 loss can land near the fp32 one by chance). In bf16 the guard
    # on B3 and B4 at 512 tokens is the bank against the plain route's,
    # within eval_text_features; the fp32 route checks only the kernels'
    # fp32 instances (the bank within fp32_features, the loss within
    # fp32_loss_rel)
    "train_first_own": {("scripts_train", "loss"): 3e-3,
                        ("multimodal_attention", "loss"): 5e-3},
    # phase 12, the first step of a LoRA run from a trained checkpoint:
    # where a group's factor gradient falls below grad_cos against the
    # plain route, the plain bf16 route itself lies as far from the plain
    # fp32 one (on an H100 80GB HBM3 at 700 W, pretrain --lora 8 from phase
    # 9's checkpoint: the text tower 0.131 from plain where plain lies 0.093
    # from fp32, √2 times it, as two independent roundings of one
    # ill-conditioned gradient lie), so the kernels' bf16 gradient must lie
    # no further from the fp32 one than this many times the plain bf16
    # route's. Readings over both LoRA runs' seven groups: 0.60 to 1.47
    # times (PERF.md). The kernels on the LoRA paths are held directly at
    # their first inputs too (hold_first_inputs, phase-2 tolerances)
    "lora_bf16_ratio": 2.0,
    # phase 13, gradcam with B2 against its plain version. B2's fp32 output
    # lies within 6e-7 of the plain one, yet that flips the bf16 rounding of
    # 44-72 of the 301056 input values, and the random-weight bf16 ResNet-50
    # carries a one-step flip to stage 4 as far (1.0e-2 to 1.2e-2 relative,
    # seeds 0-2) as its own rounding carries the plain route from fp32:
    # against the bf16 route with B2 plain the scores differ by 1.1e-3 to
    # 3.8e-2 of the largest and the min-max CAMs by 4.3e-2 to 1.6e-1, so no
    # bf16 route holds another to 1e-3. Readings of `chip_smoke.py
    # --gradcam-seeds 0 1 2 3 4 5 6 7` (PERF.md, "Grad-CAM and attention
    # rollout"; H100 80GB HBM3, 700 W): from the fp32 twin with B2 plain, the bf16 kernels lie 3.7e-3
    # to 2.2e-2 (scores) and 3.7e-2 to 9.9e-2 (CAMs), the plain bf16 route
    # 3.1e-3 to 4.0e-2 and 2.5e-2 to 1.2e-1 (their ratio 0.29 to 3.56: one
    # seed's pair is too noisy for a ratio rule). So the bf16 kernels are
    # held from the fp32 route within about twice the largest reading of
    # either bf16 route. That bound only guards against a blow-up of the
    # bf16 path, not against a kernel fault: planted in B2 on the same
    # sweep (seeds 0-2, gradcam_routes' faults), each std one bf16 step
    # too large reads 2.1e-3 to 9.1e-3 (scores) and 3.7e-2 to 6.5e-2
    # (CAMs), and the resize one source row off 9.9e-3 to 3.0e-2 and 0.18
    # to 0.56, so both pass the scores bound and the row fault passes the
    # CAMs bound at seed 2. Both routes share the plain head, so no head
    # fault shows here either (the CPU tests hold the head against JAX).
    # The kernel guard is B2 at its input within image_prep_f32 (1e-4; the
    # planted faults read 4.1e-3 to 8.0e-3 and 0.44 to 1.6 there) and each
    # kernel at its first inputs (hold_first_inputs). On the fp32 twin B2
    # against its plain version keeps the scores within
    # cam_fp32_scores_rel of the largest (readings 9.6e-5 to 1.1e-3)
    "cam_bf16_scores_rel": 8e-2,
    "cam_bf16_abs": 0.25,
    "cam_fp32_scores_rel": 2e-3,
    # phase 13, the rollout mask of the bf16 --fused-mlp ViT, kernels (B2,
    # B9) against the plain route: max |difference| and cosine (readings
    # 3.4e-4 to 4.2e-4, cosine 1.000000 to six places). A witness of the
    # path only: on random weights the mask lies in [0.88, 1], so a wrong
    # B9 would hardly move it; B9 and B2 are held at their first inputs
    "rollout": 2e-2,
    "rollout_cos": 0.999,
    # engine probabilities, kernels vs plain versions through the whole bf16
    # model (phases 3 and 5): the kernel differences above move cosines by
    # ~1e-3
    "probs_vs_plain": 5e-3,
    # MiB phase 11 may still hold on the device after a command and its
    # checks, above what it started with (what a run leaves is freed)
    "held_mib": 64,
    # service answer vs engine.probs on the same image at batch 1: the same
    # kernels on the same shapes; host vs device sigmoid
    "service": 1e-6,
    # phase 20 (c), unit image features of the served bodies, B2 against its
    # plain version: the bodies arrive at the model's size, so B2 resizes
    # nothing and its fp32 arithmetic is the plain version's; the tower is
    # the same cuDNN on the same bf16 input. Reading 0 (PR 24), against
    # 2.1e-3 between images, which phase 8's 2e-3 would barely clear
    "served_image_features": 1e-5,
    # phase 14, an exported program against the live forward on the same
    # weights, inputs and batch: the same operations and kernels in the same
    # order (logits, unit features; the probabilities within "service")
    "exported": 1e-5,
    # fp16 output |x| ≤ 2.2: a 1e-6 fp32 difference can flip one fp16
    # rounding step, 2^-9 there
    "image_prep_f16": 2.0 ** -9,
    # the parity mode (fp32 compute, flash attention) against the plain
    # route from the same weights and images: only the attention kernels'
    # summation order differs, ~1e-7 relative a layer. The unit text
    # features within 1e-5, the probabilities within 1e-5; one step's loss
    # within 1e-5 relative and each group's gradient cosine ≥ 0.9999
    "fp32_features": 1e-5,
    "fp32_probs": 1e-5,
    "fp32_loss_rel": 1e-5,
    "fp32_grad_cos": 0.9999,
    # phase 15 (a): the data-parallel step's own bounds against the plain
    # step, where its BatchNorm (flax's E[x²] − E[x]² from sums all-reduced
    # through the group) meets cuDNN's on the plain step: route -> (loss
    # rel, group -> gradient cosine), the rest at the route's bounds. Set
    # between the readings of the sound step and of a planted fault (each
    # half of the batch normalized by its own statistics: rank-local
    # BatchNorm at two ranks), which phase 15 runs and must fail every
    # bound. Readings at B = 128 (PERF.md, PR 19 runs 7-8): fp32, the image
    # tower 0.999786 against the fault's 0.187345 (the fault's loss 4.08e-2
    # rel, the other groups 0.890-0.898); bf16, the loss 1.90e-2 against
    # 4.31e-2, the image tower 0.395085 against -0.018573, the other groups
    # 0.975-0.979 against 0.869-0.883. In bf16 the random-init ResNet-50
    # carries the roundings that another BatchNorm arithmetic moves through
    # 50 layers into features, and the self-distill targets on raw features
    # (S·T up to ~1e3) into other targets; the fp32 route holds the step
    "dp_bn": {"fp32": (1e-5, {"image_tower": 0.9995}),
              "bf16": (3e-2, {"image_tower": 0.2, "image_projector": 0.95, "text_tower": 0.95,
                              "text_projector": 0.95})},
    # phase 8, the evaluation from files, kernels vs plain versions from the
    # same weights and batches. The image half, held below the spread of its
    # outputs between inputs (held): at most B2's rounding flips (one bf16
    # step at a few pixels) pass through the bf16 ResNet-50, on unit and
    # fused features and on the adapter's logits. The text half and the
    # whole route, whose spreads random weights keep near the bf16 route's
    # difference, are printed beside them: the unit text features through
    # twelve bf16 BERT layers of B3 and B4 within 4e-3 (1.2e-3 and 1.5e-3
    # on the H100 in two runs, whose phase-6 weights differ), the logits
    # within 2e-3 of a cosine (cos / 0.5; cos · 4 in InferenceSession) and
    # the probabilities within PERF.md §2's serving tolerance
    "eval_vs_plain": 5e-3,
    "eval_image_features": 2e-3,
    "eval_text_features": 4e-3,
    "eval_logits": 4e-3,
    "eval_session_logits": 8e-3,
    "eval_adapter_logits": 5e-3,
    # phase 16 (a), every tp rank's share of a full-width bf16 layer run on
    # one card against the unsharded layer, both on the kernels: each share
    # rounds its row-parallel partial product to bf16 before the sum (in
    # fp32, the bias added once), where the unsharded GEMM rounds once, so
    # an entry of the output or of the input gradient may move by one bf16
    # step of each of the t <= 4 partials and one of its own: held within
    # four bf16 steps (2^-5) of the tensor's largest entry; each weight's
    # gradient (the shares' gathered) at cosine 0.999 or better. The kernels
    # themselves are held at the shares' first inputs at their phase-2
    # tolerances, and B3/B6 on a rank's heads bit for bit the unsharded ones
    "tp_layer_rel": 2.0 ** -5,
    "tp_grad_cos": 0.999,
    # phase 17 (a), the bf16 MoE layer (fp32 masters cast in the forward)
    # against its fp32 route on the same bf16 input, relative to the
    # output's largest entry: the router runs in fp32 on the same values in
    # both, so both route alike; wi and wo round to bf16 (2^-9 relative),
    # and so do the hidden between the products and the output: each output
    # entry moves by a few of its own bf16 steps, four steps of the largest
    # entry (2^-6) bound them
    "moe_bf16_rel": 2.0 ** -6,
    # phase 17 (a), each expert product of the bf16 layer (its [E, C, K] x
    # [E, K, N] batched product, forward and backward) against the fp32
    # product of the same bf16 operands, TF32 off, relative to the
    # output's largest entry: both sum exact products in fp32, in other
    # orders (K ≤ 4000 terms: ~1e-6 typical, at most ~2e-5 of the largest
    # where the tensor cores' accumulator adds blocks in another order).
    # Products rounded to bf16, the fault this holds, move the largest
    # entries by up to half their bf16 step, ~2^-9 of the largest; phase 17
    # (a) plants that fault and must see it fail
    "moe_product_rel": 2.0 ** -14,
    # phase 17 (a), the whole layer's experts before the final cast (fp32:
    # the products, the biases, GELU, the gate) against an fp32 reference on
    # the same bf16 operands (x, wi, wo, and the hidden rounded to bf16
    # between the products), relative to the largest entry. On top of the
    # products' sums, a hidden entry that they move across a bf16 rounding
    # boundary moves the output by one bf16 step of that entry times a
    # weight: 3.126e-4 on an H100 80GB HBM3 at 700 W (PERF.md, the MoE
    # findings), the planted bf16-product fault 3.995e-3. Held between the
    # two
    "moe_products_rel": 2.0 ** -10,
    # phase 17 (d), the MoE text tower on the fp32 route at a capacity
    # factor that drops tokens in every MoE layer, routing over the group
    # against one card routing the global batch: the features relative to the largest
    # entry (fp32 sums in other orders, ~1e-6), the text tower's gradient
    # summed over the ranks at fp32_grad_cos. The planted fault, each rank
    # routing its own rows alone, drops other tokens and must fail it
    "moe_group_fp32_rel": 1e-4,
    # phase 18 (a): every pipeline stage of a full-width BERT-base run one
    # after another on one card against the unpipelined tower, both on the
    # plain routes and deterministic, TF32 off: the output relative to its
    # largest entry, and each group's gradient (the stack of layers, every
    # share's embeddings) in norm relative to the tower's. Only the order of
    # fp32 sums differs: the microbatches sum the weights' gradients in M
    # parts: 1.468e-6 (the stack) and at most 1.785e-6 (a share's
    # embeddings) on an H100 80GB HBM3 at 700 W, the output bit for bit
    # (PERF.md, the pipeline's findings). The planted faults move the stack's gradient
    # by S − 1 of its norm and a share's embeddings' by all of it
    "pp_fp32_rel": 5e-6,
    # phase 18 (a) in bf16 (fp32 masters cast in the forward): the
    # microbatches' weight gradients sum bf16 products in M parts, 2.361e-3
    # of the stack's norm at cosine 0.9999971 in the same run, the output
    # and the embeddings' gradients bit for bit
    "pp_bf16": {"rel": 1e-2, "cos": 0.9999},
    # phase 18 (b), ``pretrain --pp 2 --fp32``'s first-step loss at the
    # command's B = 16 against one card's fp32 step on the same batch and
    # weights: BatchNorm's sums over a data group of a few rows in another
    # order, as moe_ep_command_rel holds phase 17's ``--ep 2``; a wrong
    # feed, stage or embeddings gradient moves the loss by orders more
    "pp_command_rel": 5e-5,
    # phase 17 (d), ``pretrain --ep 2 --fp32``'s first-step loss at the
    # command's B = 16 against one card's fp32 step on the same batch and
    # weights: BatchNorm's sums over a data group of a few rows in other
    # orders, at this batch 8.2e-6 relative for the --num-devices 4 step and
    # 1.05e-5 for --ep 2 on four H100 80GB HBM3 at 700 W (PERF.md), where
    # dp_bn's fp32 1e-5 was set at B = 128; a wrong feed or expert shard
    # moves the loss by orders more
    "moe_ep_command_rel": 5e-5,
}

SRC = "clip_for_dl_tpu_torch/csrc/"
TPU = "clip_for_dl_tpu/ops/"
# name -> (the key its launches count under in _build.LAUNCHES, CUDA source,
# TPU kernel it replaces): one row per instance of the kernels line. The
# attention kernels have a C entry per operand type (fp16 "_f16", fp32
# "_f32"); B1 counts each pair of feature types apart, B2 its fp16 output
KERNELS = {
    "similarity": ("cxr_similarity", SRC + "similarity.cu", TPU + "similarity.py:45"),
    "similarity_bf16": ("cxr_similarity_bf16_bf16", SRC + "similarity.cu",
                        TPU + "similarity.py:45"),
    "similarity_fp16": ("cxr_similarity_fp16_fp16", SRC + "similarity.cu",
                        TPU + "similarity.py:45"),
    "image_prep": ("cxr_image_prep", SRC + "image_prep.cu", TPU + "image_prep.py:185"),
    "image_prep_f32src": ("cxr_image_prep_f32src", SRC + "image_prep.cu",
                          TPU + "image_prep.py:185"),
    "image_prep_fp16": ("cxr_image_prep_fp16", SRC + "image_prep.cu", TPU + "image_prep.py:185"),
    "image_prep_direct": ("cxr_image_prep_direct", SRC + "image_prep.cu",
                          TPU + "image_prep.py:185"),
    **{f"flash_attention{tag}": (f"cxr_flash_fwd_packed{x}", SRC + "flash_attention.cu",
                                 TPU + "flash_attention.py:309")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
    **{f"flash_attention_bwd{tag}": (f"cxr_flash_bwd_packed{x}", SRC + "flash_attention_bwd.cu",
                                     TPU + "flash_attention.py:375")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
    "mlp": ("cxr_mlp_fwd", SRC + "mlp_train.cu", TPU + "mlp_train.py:99"),
    "mlp_bwd": ("cxr_mlp_bwd", SRC + "mlp_train_bwd.cu", TPU + "mlp_train.py:112"),
    # B4 and B8 with the tanh GELU (the ViT's --fast-gelu): the same entry
    # points, counted apart
    "mlp_tanh": ("cxr_mlp_fwd_tanh", SRC + "mlp_train.cu", TPU + "mlp_train.py:99"),
    "mlp_bwd_tanh": ("cxr_mlp_bwd_tanh", SRC + "mlp_train_bwd.cu", TPU + "mlp_train.py:112"),
    "mlp_block": ("cxr_mlp_block", SRC + "mlp_block.cu", TPU + "mlp_block.py:78"),
    **{f"flash_attention_split{tag}": (f"cxr_flash_fwd{x}", SRC + "flash_attention.cu",
                                       TPU + "flash_attention.py:278")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
    **{f"flash_attention_split_bwd{tag}": (f"cxr_flash_bwd{x}", SRC + "flash_attention_bwd.cu",
                                           TPU + "flash_attention.py:343")
       for tag, x in (("", ""), ("_fp16", "_f16"), ("_fp32", "_f32"))},
}
TRAIN_KERNELS = ("image_prep", "flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd")
PATHS = {  # main path -> the kernels it must launch
    "serve": ("similarity", "image_prep", "flash_attention", "mlp"),
    "train": TRAIN_KERNELS,
    "serve_vit": ("similarity", "image_prep", "flash_attention", "mlp", "mlp_block"),
    "split_attention": ("flash_attention_split", "flash_attention_split_bwd"),
    "layout_probe": ("flash_attention_bwd", "flash_attention_split_bwd"),
    "pretrain_fit": TRAIN_KERNELS,
    "adapter": ("image_prep",),
    # evaluation from files (phase 8): the prompt bank, the zero-shot drivers
    # and InferenceSession; the adapter checkpoint through AdapterEngine
    "eval_files": ("similarity", "image_prep", "flash_attention", "mlp"),
    "eval_adapter": ("image_prep",),
    # the command line (phase 9): each command's run in the process
    "cli_pretrain": TRAIN_KERNELS,
    "cli_adapter": ("image_prep",),
    "cli_zeroshot": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_zeroshot_dynamic": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_eval": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_eval_adapter": ("image_prep",),
    "cli_zeroshot_vit": ("similarity", "image_prep", "flash_attention", "mlp", "mlp_block"),
    # phase 10: the HTTP server in a child process, both heads (the child's
    # own counts); the report-built banks; pretrain with the A3b options;
    # eval of the EMA slot
    "cli_serve": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_serve_adapter": ("image_prep",),
    "cli_banks": ("flash_attention", "mlp"),
    "cli_pretrain_a3b": TRAIN_KERNELS,
    "cli_pretrain_info_nce": TRAIN_KERNELS,
    "cli_eval_ema": ("similarity", "image_prep", "flash_attention", "mlp"),
    # phase 11: train in both presets (B2 a step, B3 and B4 in the epoch's
    # prompt bank), the multimodal zero-shot, the shared adapter (the reports
    # through BERT each step)
    "cli_train": ("image_prep", "flash_attention", "mlp"),
    "cli_train_multimodal": ("image_prep", "flash_attention", "mlp"),
    "cli_zeroshot_multimodal": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_shared_adapter": ("image_prep", "flash_attention", "mlp"),
    # the parity mode (--fp32 --flash-attention): zero-shot serving and a
    # phase-A step in fp32
    "serve_fp32": ("similarity", "image_prep", "flash_attention_fp32"),
    "train_fp32": ("image_prep", "flash_attention_fp32", "flash_attention_bwd_fp32"),
    # phase 12: the ViT train step with the exact and the tanh GELU (B4 and
    # B8 in both towers; the tanh form in the ViT's); pretrain --preset vit
    # --fast-gelu --vit-fused-mlp-train; LoRA on ResNet (the text tower's
    # kernels) and on a --fused-mlp ViT (B9 in eval mode, its plain
    # backward); zeroshot on each folded model
    "vit_train": TRAIN_KERNELS,
    "vit_train_tanh": TRAIN_KERNELS + ("mlp_tanh", "mlp_bwd_tanh"),
    "cli_pretrain_vit": TRAIN_KERNELS + ("mlp_tanh", "mlp_bwd_tanh"),
    "cli_pretrain_lora": TRAIN_KERNELS,
    "cli_pretrain_vit_lora": ("image_prep", "flash_attention", "flash_attention_bwd",
                              "mlp_block"),
    "cli_zeroshot_lora": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_zeroshot_vit_lora": ("similarity", "image_prep", "flash_attention", "mlp_block"),
    # the attention entry points with autograd in the types no preset runs
    # phase 13: Grad-CAM (the bank's B3 and B4, B2 to fp32) and the rollout
    # (B2, B9; sowing keeps B3 off), as library calls and as commands
    "gradcam": ("image_prep", "flash_attention", "mlp"),
    "rollout": ("image_prep", "mlp_block"),
    "cli_gradcam": ("image_prep", "flash_attention", "mlp"),
    "cli_rollout": ("image_prep", "mlp_block"),
    # phase 14: serve --exported in a child process, both heads; both
    # programs in this process; the text encoder and the ViT scorer exported
    # on the card
    "export_serve": ("similarity", "image_prep"),
    "export_serve_adapter": ("image_prep",),
    "export_programs": ("similarity", "image_prep"),
    "export_text": ("flash_attention", "mlp"),
    "export_vit": ("similarity", "image_prep", "flash_attention", "mlp_block"),
    "typed_attention": ("flash_attention_fp16", "flash_attention_bwd_fp16",
                        "flash_attention_split_fp16", "flash_attention_split_bwd_fp16",
                        "flash_attention_split_fp32", "flash_attention_split_bwd_fp32"),
    # B1 and B2 on the inputs C8 opened to them, through the public functions
    "c8_cases": ("similarity_bf16", "similarity_fp16", "image_prep_f32src", "image_prep_fp16",
                 "image_prep_direct"),
    # phase 15, each rank of the NCCL group (the kernels line counts them
    # as path@rankN): the phase-A step through parallel.dp in bf16 and on
    # the fp32 route, the local-loss forms (fp32), GradCache on the ViT, and
    # pretrain --accum-steps and zeroshot from the command line
    "dp_step": TRAIN_KERNELS,
    "dp_step_fp32": ("image_prep", "flash_attention_fp32", "flash_attention_bwd_fp32"),
    "dp_local": ("image_prep", "flash_attention_fp32", "flash_attention_bwd_fp32"),
    "dp_accum": TRAIN_KERNELS,
    "cli_dp_pretrain": TRAIN_KERNELS,
    "cli_dp_zeroshot": ("similarity", "image_prep", "flash_attention", "mlp"),
    # phase 16: every tp rank's share of a full-width BERT and ViT layer on
    # one card (forward and backward); in each rank of the NCCL group the
    # engine (data-parallel, and tensor-parallel at each degree), the TP
    # step (bf16), sequence_sharded_fn (replicated and with tp_params) and
    # zeroshot --tp; serve over the group, both towers (B9 on each rank's
    # data slice), every rank's launches
    **{f"tp_shares_{kind}_{t}": ("flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd")
       for kind in ("bert", "vit") for t in (2, 4)},
    **{f"tp_engine_{name}": ("similarity", "image_prep", "flash_attention", "mlp")
       for name in ("dp", "tp1", "tp2", "tp4")},
    **{f"tp_step_{t}": TRAIN_KERNELS for t in (1, 2, 4)},
    **{f"sp_text{tag}_{t}": ("flash_attention", "mlp") for tag in ("", "_tp") for t in (1, 2, 4)},
    "cli_tp_zeroshot": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_group_serve": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_group_serve_vit": ("similarity", "image_prep", "flash_attention", "mlp", "mlp_block"),
    # phase 17: the phase-A step with the MoE text tower (B4 and B8 in its
    # dense layers), pretrain and zeroshot with --moe-experts, and in each
    # rank of the NCCL group pretrain --num-devices --moe-experts and the
    # --ep steps (bf16)
    "moe_train": TRAIN_KERNELS,
    "cli_pretrain_moe": TRAIN_KERNELS,
    "cli_zeroshot_moe": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_dp_pretrain_moe": TRAIN_KERNELS,
    **{f"ep_step_{e}": TRAIN_KERNELS for e in (2, 4, 8)},
    "cli_ep_pretrain_moe": ("image_prep", "flash_attention_fp32", "flash_attention_bwd_fp32"),
    # phase 18: in each rank the pipelined step (B2 alone: the pipelined
    # text tower runs on the plain routes, as JAX builds it) and pretrain
    # --pp 2 --fp32 (B2 a step, B3's fp32 instance in the eval pass on the
    # gathered tower); zeroshot of its unstacked checkpoint in this process
    **{f"pp_step_{s}": ("image_prep",) for s in (1, 2, 4)},
    "cli_pp_pretrain": ("image_prep", "flash_attention_fp32"),
    "cli_zeroshot_pp": ("similarity", "image_prep", "flash_attention", "mlp"),
    # phase 19: the phase-A step under --remat in each policy (B3 and B4
    # twice a layer under full); the plain attention route with
    # --bf16-attention-probs (B2, B4 and B8: no B3); eval and gradcam over
    # the group and alone; with four cards pretrain --ep 2 over the processes
    **{f"remat_train_{p}": TRAIN_KERNELS for p in ("full", "dots", "dots_no_batch")},
    "bf16_probs_train": ("image_prep", "mlp", "mlp_bwd"),
    "cli_group_eval": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_group_gradcam": ("image_prep", "flash_attention", "mlp"),
    "cli_ep_processes": ("image_prep", "flash_attention_fp32", "flash_attention_bwd_fp32"),
    # phase 20: zeroshot over the layout as JPEG files and over its PNG twin;
    # serve answering JPEG, BMP and PNG bodies (the child's own counts)
    "cli_zeroshot_jpeg": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_zeroshot_twin": ("similarity", "image_prep", "flash_attention", "mlp"),
    "cli_serve_jpeg": ("similarity", "image_prep", "flash_attention", "mlp"),
    # phase 21: zeroshot over the layout as 16-bit TIFF and PGM files and over
    # its PNGs; serve answering TIFF, PGM, PPM, JPEG, BMP and PNG bodies
    **{f"cli_zeroshot_{tag}21": ("similarity", "image_prep", "flash_attention", "mlp")
       for tag in ("tiff", "pgm", "png")},
    "cli_serve_tiff": ("similarity", "image_prep", "flash_attention", "mlp"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 and fp16 on the tensor
# cores and fp32 on the CUDA cores, in operations a second; HBM3 in bytes a
# second
PEAK = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
VIT_TOKENS = 197  # ViT-B/16 at 224: 14 x 14 patches and the class token
BATCH = 256  # images per zero-shot batch (512x512 grey uint8)
N_BATCHES = 6  # batches per streamed run
TRAIN_BATCH = 128  # image-report pairs per train step
TRAIN_STEPS = 10  # steps on one fixed batch
TRAIN_LEN = 200  # report tokens (the preset's max_text_length)
CHAIN_STEPS = 4  # steps per epoch of phase 6's fits
TRAIN_EPOCHS = 3  # epochs of phase 11's train commands, 4 steps each at B = 32
EVAL_UIDS = 256  # exams of phase 8's files
EVAL_SIZES = ((512, 512), (600, 512))  # their PNGs' sizes, in turn
EVAL_BATCH = 128  # exams a batch of phase 8's loader
EVAL_PASSES = 10  # passes over the cached loader that phase 8's host rates time
DECODE_FILES = 48  # PNGs whose decode phase 8 times in one thread and in 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def import_port():
    """The port package from this checkout (not from anywhere else)."""
    sys.path.insert(0, str(ROOT))
    try:
        import clip_for_dl_tpu_torch
    except ImportError as exc:
        raise SmokeFailure(f"the port package is not beside this script: {exc}")
    check(Path(clip_for_dl_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"imported the port from {clip_for_dl_tpu_torch.__file__}, not from {ROOT}")
    from clip_for_dl_tpu_torch.ops import (
        _build, flash_attention, image_prep, mlp_block, mlp_train, similarity,
    )

    return _build, {"similarity": similarity, "image_prep": image_prep,
                    "flash_attention": flash_attention, "mlp_train": mlp_train,
                    "mlp_block": mlp_block}


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not measured"


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """ms of one call of ``fn``: the median of five CUDA-event timings of
    ``iters`` calls each, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(flops: float, tensors, peak: str = "bf16"):
    """The least time the card could take for one call: the larger of the
    bytes it must move (each input read once, each output written once) over
    the HBM rate and its operations over the dense peak of ``peak``. Returns
    (ms, what bounds it, a description of the work)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / PEAK[peak], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes",
            f"{flops / 1e9:.2f} G{peak} operations, {nbytes / 1e6:.1f} MB")


def set_bound(results: dict, name: str, flops: float, tensors, peak: str = "bf16") -> None:
    ms, by, work = bound(flops, tensors, peak)
    results[name].update(bound_ms=ms, bound_by=by)
    print(f"  {name} bound: {ms:.4f} ms by {by} ({work})")


def sdpa_backend(q, k, v, mask) -> str:
    """The backend F.scaled_dot_product_attention picks for these inputs
    (its own dispatch rule, torch._fused_sdp_choice), or "not measured"
    where this torch does not say."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, mask)).name
    except (AttributeError, ImportError, RuntimeError, TypeError, ValueError):
        return "not measured"


def sdpa_ms(q, k, v, bias, do=None) -> float:
    """Time of one PyTorch call for the same attention at rate 0:
    F.scaled_dot_product_attention on contiguous head-major [B, H, N, D]
    copies of q, k, v with the key bias as a [B, 1, 1, N] mask in their
    dtype; with ``do`` (made contiguous too), the time of its backward alone.
    Prints the backend it picked. A yardstick only: the port never calls
    it."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    xs = [t.detach().contiguous().requires_grad_(do is not None) for t in (q, k, v)]
    backend = sdpa_backend(*xs, mask)
    if do is None:
        ms = cuda_ms(lambda: sdpa(*xs, attn_mask=mask), iters=10)
    else:
        out, do = sdpa(*xs, attn_mask=mask), do.contiguous()
        ms = cuda_ms(lambda: torch.autograd.grad(out, xs, do, retain_graph=True), iters=10)
    print(f"  F.scaled_dot_product_attention{' backward' if do is not None else ''} at "
          f"{tuple(q.shape)}, rate 0 ({backend}): {ms:.4f} ms")
    return ms


def kernel_device_ms(fn, names, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` spent in the kernels whose names contain
    each of ``names`` (torch.profiler over ``calls`` calls after one), as
    strings; "not measured" where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(names, 0.0)
    for avg in prof.key_averages():
        for name in names:
            if name in avg.key:
                totals[name] += getattr(avg, "device_time_total", 0.0)
    return {k: f"{v / 1e3 / calls:.4f}" if v > 0 else "not measured" for k, v in totals.items()}


def heads_of(qkv, H: int):
    """Head-major [B, H, N, D] views of a packed qkv's q, k and v."""
    B, N, _ = qkv.shape
    return qkv.view(B, N, 3, H, -1).permute(2, 0, 3, 1, 4).unbind(0)


def compare(name, got, want, tol, results):
    import torch

    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-3)).max())
    print(f"  {name}: max_abs {max_abs:.3e}  max_rel {max_rel:.3e}  tol {tol:.1e}")
    check(max_abs <= tol, f"{name}: max_abs {max_abs} > tol {tol}")
    results.setdefault(name, {})["max_abs_err"] = max(
        max_abs, results.get(name, {}).get("max_abs_err", 0.0))


def compare_grads(name, got, want, layout, results, heads=None):
    """An attention backward kernel's gradient against its plain version's,
    per (batch row, head) slice (fa.grad_slice_error): finite, and each slice
    within two bf16 steps of that slice's own largest entry."""
    import torch

    from clip_for_dl_tpu_torch.ops.flash_attention import grad_slice_error

    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    max_abs, worst = grad_slice_error(got, want, layout, heads)
    print(f"  {name}: max_abs {max_abs:.3e}  worst (batch row, head) slice at {worst:.3f} "
          "of its tolerance")
    check(worst <= 1.0, f"{name}: a slice is off by {worst} of its tolerance")
    results.setdefault(name, {})["max_abs_err"] = max(
        max_abs, results.get(name, {}).get("max_abs_err", 0.0))


def phase2(mods, dev, seed: int, batch: int, results: dict) -> None:
    import torch

    sim, prep = mods["similarity"], mods["image_prep"]
    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)

    print(f"B1 similarity: img [{batch}, 512] x txt [16, 512] fp32, T = 0.5")
    img = torch.randn(batch, 512, device=dev, generator=g)
    img[-1] = 0.0  # a padded bucket row
    txt = torch.randn(16, 512, device=dev, generator=g)
    compare("similarity", sim.similarity(img, txt, 0.5),
            sim.similarity_reference(img, txt, 0.5), TOL["similarity"], results)
    results["similarity"]["ms"] = cuda_ms(lambda: sim.similarity(img, txt, 0.5))
    results["similarity"]["plain_ms"] = cuda_ms(lambda: sim.similarity_reference(img, txt, 0.5))
    # one PyTorch call of B1's function, each norm clamped at eps; a yardstick
    # the port never calls
    cos = torch.nn.functional.cosine_similarity
    results["similarity"]["library_ms"] = cuda_ms(
        lambda: cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5)
    lib_err = float((cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5
                     - sim.similarity(img, txt, 0.5)).abs().max())
    print(f"  F.cosine_similarity / T: {results['similarity']['library_ms']:.4f} ms, "
          f"max_abs {lib_err:.3e} from the kernel; B1's device ms a call (torch.profiler) "
          f"{kernel_device_ms(lambda: sim.similarity(img, txt, 0.5), ('similarity',))}")
    # the product, and a square, a sum and a scale per input value
    set_bound(results, "similarity", 2 * batch * 16 * 512 + 3 * (batch + 16) * 512,
              (img, txt, sim.similarity(img, txt, 0.5)), "fp32")

    print(f"B2 image prep: [{batch}, 512, 512, 1] uint8 -> [{batch}, 224, 224, 3] bf16; "
          "and [8, 224, 224, 3] and [1, 224, 224, 3] identity")
    grey = torch.randint(0, 256, (batch, 512, 512, 1), device=dev, generator=g,
                         dtype=torch.uint8)
    rgb = torch.randint(0, 256, (8, 224, 224, 3), device=dev, generator=g, dtype=torch.uint8)
    for images in (grey, rgb, rgb[:1]):
        compare("image_prep", prep.preprocess_images(images, 224, 224, mean, std),
                prep.preprocess_reference(images, 224, 224, mean, std),
                TOL["image_prep"], results)
        compare("image_prep_f32",
                prep.preprocess_images(images, 224, 224, mean, std, torch.float32),
                prep.preprocess_reference(images, 224, 224, mean, std, torch.float32),
                TOL["image_prep_f32"], results)
    results.pop("image_prep_f32")
    results["image_prep"]["ms"] = cuda_ms(
        lambda: prep.preprocess_images(grey, 224, 224, mean, std))
    results["image_prep"]["plain_ms"] = cuda_ms(
        lambda: prep.preprocess_reference(grey, 224, 224, mean, std))
    out = prep.preprocess_images(grey, 224, 224, mean, std)
    # per output value: a 2x2 bilinear blend (4 multiply-adds) and a scale
    # and shift
    set_bound(results, "image_prep", 10 * out.numel(), (grey, out), "fp32")
    prep_yardstick(prep, grey, out, mean, std, results["image_prep"]["ms"])
    one = rgb[:1]
    one_out = prep.preprocess_images(one, 224, 224, mean, std)
    extra_times("B2 at one request [1, 224, 224, 3]",
                lambda: prep.preprocess_images(one, 224, 224, mean, std),
                lambda: prep.preprocess_reference(one, 224, 224, mean, std),
                10 * one_out.numel(), (one, one_out), peak="fp32")
    prep_yardstick(prep, one, one_out, mean, std, None)

    print("B3 attention: qkv [64, 200, 2304] bf16, 12 heads of 64, padded keys")
    qkv = torch.randn(64, 200, 3 * 768, device=dev, generator=g).bfloat16()
    lengths = torch.randint(3, 201, (64, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(200, device=dev)[None] < lengths, 0.0, -1e10)
    compare("flash_attention", fa.flash_attention_packed(qkv, 12, bias),
            fa.flash_attention_packed_reference(qkv, 12, bias), TOL["flash_attention"],
            results)
    results["flash_attention"]["ms"] = cuda_ms(lambda: fa.flash_attention_packed(qkv, 12, bias))
    results["flash_attention"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_packed_reference(qkv, 12, bias))
    set_bound(results, "flash_attention", 4 * 64 * 12 * 200 * 200 * 64,
              (qkv, bias, fa.flash_attention_packed(qkv, 12, bias)))
    results["flash_attention"]["library_ms"] = sdpa_ms(*heads_of(qkv, 12), bias)

    print("B4 MLP: x [12800, 768] bf16, W1 [3072, 768], W2 [768, 3072]")
    x = torch.randn(12800, 768, device=dev, generator=g).bfloat16()
    w1 = (torch.randn(3072, 768, device=dev, generator=g) * 0.02).bfloat16()
    b1 = (torch.randn(3072, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(768, 3072, device=dev, generator=g) * 0.02).bfloat16()
    b2 = (torch.randn(768, device=dev, generator=g) * 0.02).bfloat16()
    compare("mlp", mlp.dense_gelu_dense(x, w1, b1, w2, b2),
            mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), TOL["mlp"], results)
    results["mlp"]["ms"] = cuda_ms(lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2), iters=10)
    results["mlp"]["plain_ms"] = cuda_ms(
        lambda: mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), iters=10)
    set_bound(results, "mlp", 4 * 12800 * 768 * 3072,
              (x, w1, b1, w2, b2, mlp.dense_gelu_dense(x, w1, b1, w2, b2)))
    mlp_fwd_yardstick("B4", lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2), x, w1, w2)
    del x

    print(f"B3 attention at the ViT shape: qkv [{batch}, {VIT_TOKENS}, 2304] bf16, no key bias")
    qkv = torch.randn(batch, VIT_TOKENS, 3 * 768, device=dev, generator=g).bfloat16()
    compare("flash_attention", fa.flash_attention_packed(qkv, 12),
            fa.flash_attention_packed_reference(qkv, 12), TOL["flash_attention"], results)
    extra_times("B3 at the ViT shape", lambda: fa.flash_attention_packed(qkv, 12),
                lambda: fa.flash_attention_packed_reference(qkv, 12),
                4 * batch * 12 * VIT_TOKENS ** 2 * 64, (qkv, fa.flash_attention_packed(qkv, 12)),
                sdpa_ms(*heads_of(qkv, 12), None))
    del qkv

    check_mlp_block(mods["mlp_block"], dev, seed, batch * VIT_TOKENS, results)
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")


def check_mlp_block(blk, dev, seed: int, rows: int, results: dict) -> None:
    """B9 against its plain version at ``rows`` x 768 x 3072 (exact and tanh
    GELU) and at one request's 197 rows, then both times. x at std 1,
    weights at std fan_in^-1/2 and every LayerNorm parameter and bias at std
    0.1 in fp32, so that each input moves the output by more than the
    tolerance. The MLP branch out - x is held, not out: the residual, which
    both sides add, would set the scale of a tolerance on out."""
    import torch

    g = torch.Generator(dev).manual_seed(seed + 5)
    H, F = 768, 3072
    print(f"B9 MLP block: x [{rows}, {H}] bf16, W1 [{F}, {H}], W2 [{H}, {F}], fp32 "
          f"LayerNorm parameters and biases; exact and tanh GELU; one request's "
          f"{VIT_TOKENS} rows")
    x = torch.randn(rows, H, device=dev, generator=g).bfloat16()
    ls = 1.0 + 0.1 * torch.randn(H, device=dev, generator=g)
    lb = 0.1 * torch.randn(H, device=dev, generator=g)
    w1 = (torch.randn(F, H, device=dev, generator=g) * H ** -0.5).bfloat16()
    b1 = 0.1 * torch.randn(F, device=dev, generator=g)
    w2 = (torch.randn(H, F, device=dev, generator=g) * F ** -0.5).bfloat16()
    b2 = 0.1 * torch.randn(H, device=dev, generator=g)
    args = (x, ls, lb, w1, b1, w2, b2)
    one = (x[:VIT_TOKENS],) + args[1:]
    for a, approximate in ((args, False), (args, True), (one, False)):
        xf = a[0].float()
        want = blk.fused_mlp_block_reference(*a, gelu_approximate=approximate).float() - xf
        got = blk.fused_mlp_block(*a, gelu_approximate=approximate).float() - xf
        compare("mlp_block", got, want,
                TOL["mlp_block_rel"] * float(want.abs().max()), results)
    del xf, want, got
    results["mlp_block"]["ms"] = cuda_ms(lambda: blk.fused_mlp_block(*args), iters=10)
    results["mlp_block"]["plain_ms"] = cuda_ms(
        lambda: blk.fused_mlp_block_reference(*args), iters=10)
    set_bound(results, "mlp_block", 4 * rows * H * F, args + (blk.fused_mlp_block(*args),))
    mlp_fwd_yardstick("B9", lambda: blk.fused_mlp_block(*args), x, w1, w2)
    extra_times(f"B9 at one request ({VIT_TOKENS} rows)", lambda: blk.fused_mlp_block(*one),
                lambda: blk.fused_mlp_block_reference(*one), 4 * VIT_TOKENS * H * F,
                one + (blk.fused_mlp_block(*one),))
    mlp_fwd_yardstick(f"B9 at one request ({VIT_TOKENS} rows)",
                      lambda: blk.fused_mlp_block(*one), one[0], w1, w2)


def mlp_fwd_yardstick(what: str, kernel, x, w1, w2) -> None:
    """Print the device time of each kernel of an MLP forward call (B4: the
    GEMM pair; B9: also its LayerNorm pass) and, as a yardstick the port
    never calls, the time of its two products alone in cuBLAS (torch.matmul,
    bf16: x·W1ᵀ, then g·W2ᵀ on a bf16 g of the same shape)."""
    import torch

    g = torch.empty(x.shape[0], w1.shape[0], dtype=torch.bfloat16, device=x.device).normal_()
    products = cuda_ms(lambda: (torch.matmul(x, w1.T), torch.matmul(g, w2.T)), iters=10)
    split = kernel_device_ms(kernel, ("mlp_block_ln_kernel", "mlp_fwd_gelu_kernel",
                                      "mlp_fwd_out_kernel"))
    print(f"  {what}: its two products alone in cuBLAS {products:.4f} ms (a yardstick, never "
          "called by the port); device ms a call (torch.profiler): "
          + ", ".join(f"{k} {v}" for k, v in split.items()))


def mlp_bwd_yardstick(what: str, mlp, x, w1, b1, w2, dy) -> None:
    """Print, as a yardstick the port never calls, the time of B8's three
    products alone in cuBLAS (torch.matmul, bf16: x·W1ᵀ, dy·W2, dh·W1)."""
    import torch

    dh = mlp._kernel_bwd(x, w1, b1, w2, dy)[2]
    products = cuda_ms(lambda: (torch.matmul(x, w1.T), torch.matmul(dy, w2),
                                torch.matmul(dh, w1)), iters=5)
    print(f"  yardstick, never called by the port: {what}'s three products alone in cuBLAS "
          f"(torch.matmul, bf16: x·W1ᵀ, dy·W2, dh·W1) {products:.4f} ms")


def prep_yardstick(prep, images, out, mean, std, event_ms) -> None:
    """Print B2's device time (torch.profiler) beside its event time, the
    GB/s it reaches on the bytes it must move (input read once, output
    written once), and as a bandwidth yardstick the port never calls, one
    ``Tensor.copy_`` of a tensor of the output's size (bytes read and
    written)."""
    import torch

    dev_ms = kernel_device_ms(
        lambda: prep.preprocess_images(images, 224, 224, mean, std), ("image_prep",),
        calls=20)["image_prep"]
    nbytes = images.numel() * images.element_size() + out.numel() * out.element_size()
    src = torch.empty_like(out).normal_()
    dst = torch.empty_like(out)
    copy_ms = cuda_ms(lambda: dst.copy_(src))
    copy_bytes = 2 * out.numel() * out.element_size()
    rate = "not measured" if dev_ms == "not measured" else \
        f"{nbytes / float(dev_ms) / 1e6:.1f} GB/s"
    event = "" if event_ms is None else f"events {event_ms:.4f} ms, "
    print(f"  B2 at {list(images.shape)}: {event}device {dev_ms} ms a call (torch.profiler), "
          f"{rate} on {nbytes / 1e6:.1f} MB; Tensor.copy_ of {list(out.shape)} "
          f"{out.dtype}: {copy_ms:.4f} ms, {copy_bytes / copy_ms / 1e6:.1f} GB/s on "
          f"{copy_bytes / 1e6:.1f} MB (a yardstick, never called by the port)")


def extra_times(what: str, kernel, plain, flops: float, io, library_ms=None,
                peak: str = "bf16") -> None:
    """Print the figures of a shape off the kernels line: kernel and plain
    times, the bound of ``flops`` over the tensors ``io`` (as set_bound) and,
    for attention, the SDPA time measured on the same inputs at rate 0."""
    ms, by, work = bound(flops, io, peak)
    sdpa = "" if library_ms is None else f"  SDPA {library_ms:.4f} ms"
    print(f"  {what}: kernel {cuda_ms(kernel, iters=10):.4f} ms  "
          f"plain {cuda_ms(plain, iters=10):.4f} ms  bound {ms:.4f} ms by {by} ({work}){sdpa}")


def dropout_probe(B: int, N: int, H: int, D: int, dev):
    """Attention inputs whose outputs show the dropout mask: q = k = 0, so
    every kept probability of a row is the same nonzero constant; batch row b
    attends only to the keys of window w = b mod ceil(N / D), [wD, wD + D),
    where v_j is one-hot at dim j - wD; and d(out) is one-hot at dim i - w'D
    for the query rows of window w' = (b // ceil(N / D)) mod ceil(N / D), zero
    elsewhere. Then out[b, i, h, j - wD] and dv[b, j, h, i - w'D] are nonzero
    exactly where (i, j) is kept, so a zero pattern compared between the
    kernel and the plain version compares the masks bit for bit."""
    import torch

    nwin = -(-N // D)
    pos = torch.arange(N, device=dev)
    win = torch.arange(B, device=dev) % nwin
    in_key = (pos[None] // D) == win[:, None]  # [B, N]
    in_row = (pos[None] // D) == ((torch.arange(B, device=dev) // nwin) % nwin)[:, None]
    onehot = torch.nn.functional.one_hot(pos % D, D).float()  # [N, D]
    qkv = torch.zeros(B, N, 3, H, D, device=dev)
    qkv[:, :, 2] = (onehot[None] * in_key[..., None])[:, :, None, :]
    do = (onehot[None] * in_row[..., None])[:, :, None, :].expand(B, N, H, D)
    bias = torch.where(in_key, 0.0, -1e10)
    return (qkv.reshape(B, N, 3 * H * D).bfloat16(), do.reshape(B, N, H * D).bfloat16(),
            bias)


def phase2_train(mods, dev, seed: int, results: dict) -> None:
    """B3 with dropout, B6 and B8 at the train path's shapes."""
    import torch

    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed + 1)
    B, N, H, D = TRAIN_BATCH, TRAIN_LEN, 12, 64

    print(f"B3 attention with dropout 0.1: qkv [{B}, {N}, {3 * H * D}] bf16, padded keys")
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    compare("flash_attention", fa.flash_attention_packed(qkv, H, bias, **drop),
            fa.flash_attention_packed_reference(qkv, H, bias, **drop),
            TOL["flash_attention"], results)
    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    got = fa.flash_attention_packed(pq, H, pbias, **drop)
    want = fa.flash_attention_packed_reference(pq, H, pbias, **drop)
    kept = want != 0
    check(torch.equal(got != 0, kept), "B3 dropout mask differs from the plain version's")
    probed = int((pbias == 0).sum()) * N * H  # (row, key, head) triples in the windows
    gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
    wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
        B, N, 3, H, D)[:, :, 2]
    check(torch.equal(gdv != 0, wdv != 0), "B6 dropout mask differs from the plain version's")
    print(f"  dropout masks equal bit for bit over {probed} (row, key, head) triples, "
          f"in B3's output and B6's dv; kept share {float(kept.sum()) / probed:.4f}")
    extra_times("B3 with dropout 0.1 at the train shape",
                lambda: fa.flash_attention_packed(qkv, H, bias, **drop),
                lambda: fa.flash_attention_packed_reference(qkv, H, bias, **drop),
                4 * B * H * N * N * D,
                (qkv, bias, drop["dropout_seeds"], fa.flash_attention_packed(qkv, H, bias, **drop)),
                sdpa_ms(*heads_of(qkv, H), bias))

    print(f"B6 attention backward: qkv [{B}, {N}, {3 * H * D}], d(out) [{B}, {N}, {H * D}] "
          "bf16, rates 0 and 0.1")
    do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
    for rate in (0.0, 0.1):
        kw = drop if rate else {}
        want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw)
        compare_grads("flash_attention_bwd", fa._kernel_bwd(qkv, do, H, bias, **kw), want,
                      "packed", results, H)
    results["flash_attention_bwd"]["ms"] = cuda_ms(
        lambda: fa._kernel_bwd(qkv, do, H, bias, **drop), iters=10)
    results["flash_attention_bwd"]["plain_ms"] = cuda_ms(
        lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop), iters=10)
    # five products of 2·N²·D a head: s, dp, dv, dq, dk
    set_bound(results, "flash_attention_bwd", 10 * B * H * N * N * D,
              (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias, **drop)))
    results["flash_attention_bwd"]["library_ms"] = sdpa_ms(
        *heads_of(qkv, H), bias, do.view(B, N, H, D).transpose(1, 2))
    # also P1's shape: its plain version at rate 0
    extra_times("B6 at rate 0 at the train shape", lambda: fa._kernel_bwd(qkv, do, H, bias),
                lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias),
                10 * B * H * N * N * D, (qkv, do, bias, fa._kernel_bwd(qkv, do, H, bias)),
                results["flash_attention_bwd"]["library_ms"])

    R, HID, F = B * N, 768, 3072
    print(f"B8 MLP backward: x, dy [{R}, {HID}] bf16, W1 [{F}, {HID}], W2 [{HID}, {F}]")
    x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
    dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
    w1 = (torch.randn(F, HID, device=dev, generator=g) * 0.02).bfloat16()
    b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(HID, F, device=dev, generator=g) * 0.02).bfloat16()
    got = mlp._kernel_bwd(x, w1, b1, w2, dy)
    want = mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)
    for name, a_, b_ in zip(("dx", "g", "dh"), got, want):
        print(f"  {name}:", end="")
        compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
    # the kernel recomputes h = x·W1ᵀ, then g = dy·W2 and dx = dh·W1
    set_bound(results, "mlp_bwd", 6 * R * HID * F, (x, w1, b1, w2, dy) + tuple(got))
    del got, want
    results["mlp_bwd"]["ms"] = cuda_ms(lambda: mlp._kernel_bwd(x, w1, b1, w2, dy), iters=5)
    results["mlp_bwd"]["plain_ms"] = cuda_ms(
        lambda: mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy), iters=5)
    mlp_bwd_yardstick("B8", mlp, x, w1, b1, w2, dy)
    split = kernel_device_ms(lambda: mlp._kernel_bwd(x, w1, b1, w2, dy),
                             ("mlp_bwd_gelu_kernel", "mlp_bwd_dx_kernel"))
    print("  B8's two kernels, device ms a call (torch.profiler): "
          + ", ".join(f"{k} {v}" for k, v in split.items()))
    for name in ("flash_attention_bwd", "mlp_bwd"):
        r = results[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")


def phase2_tanh(mods, dev, seed: int, results: dict) -> None:
    """B4 and B8 with the tanh GELU (the ViT's --fast-gelu) at the ViT train
    shape, B = 128 images of 197 tokens: [25216, 768] x 3072, against their
    plain versions at the erf rows' tolerances; times, bounds and the
    products alone in cuBLAS."""
    import torch

    mlp = mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed + 11)
    R, HID, F = TRAIN_BATCH * VIT_TOKENS, 768, 3072
    print(f"B4 and B8 with the tanh GELU: x, dy [{R}, {HID}] bf16, W1 [{F}, {HID}], "
          f"W2 [{HID}, {F}]")
    x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
    dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
    w1 = (torch.randn(F, HID, device=dev, generator=g) * HID ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=dev, generator=g) * 0.1).bfloat16()
    w2 = (torch.randn(HID, F, device=dev, generator=g) * F ** -0.5).bfloat16()
    b2 = (torch.randn(HID, device=dev, generator=g) * 0.1).bfloat16()

    def fwd():
        return mlp._kernel(x, w1, b1, w2, b2, True)

    def fwd_plain():
        return mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2, True)

    def bwd():
        return mlp._kernel_bwd(x, w1, b1, w2, dy, True)

    def bwd_plain():
        return mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy, True)

    compare("mlp_tanh", fwd(), fwd_plain(), TOL["mlp"], results)
    check(not torch.equal(fwd(), mlp._kernel(x, w1, b1, w2, b2)),
          "B4 gives the erf form's output with the tanh flag")
    results["mlp_tanh"].update(ms=cuda_ms(fwd, iters=10), plain_ms=cuda_ms(fwd_plain, iters=5))
    set_bound(results, "mlp_tanh", 4 * R * HID * F, (x, w1, b1, w2, b2, fwd()))
    mlp_fwd_yardstick("B4, tanh", fwd, x, w1, w2)
    got = bwd()
    for name, a_, b_ in zip(("dx", "g", "dh"), got, bwd_plain()):
        print(f"  {name}:", end="")
        compare("mlp_bwd_tanh", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()),
                results)
    check(not torch.equal(got[1], mlp._kernel_bwd(x, w1, b1, w2, dy)[1]),
          "B8 gives the erf form's g with the tanh flag")
    set_bound(results, "mlp_bwd_tanh", 6 * R * HID * F, (x, w1, b1, w2, dy) + tuple(got))
    del got
    results["mlp_bwd_tanh"].update(ms=cuda_ms(bwd, iters=5), plain_ms=cuda_ms(bwd_plain, iters=3))
    mlp_bwd_yardstick("B8, tanh", mlp, x, w1, b1, w2, dy)
    split = kernel_device_ms(bwd, ("mlp_bwd_gelu_kernel", "mlp_bwd_dx_kernel"))
    print("  B8's two kernels with the tanh GELU, device ms a call (torch.profiler): "
          + ", ".join(f"{k} {v}" for k, v in split.items()))
    for name in ("mlp_tanh", "mlp_bwd_tanh"):
        r = results[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms")


def phase2_repairs(mods, dev, seed: int, results: dict) -> None:
    """The widths ROADMAP C1-C3 repaired: B3 and B6 at head dim 128 and
    N = 512 (with padded keys; B6 at rates 0 and 0.1, its dropout mask
    compared bit for bit), B4 and B8 at hidden 256."""
    import torch

    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed + 4)
    B, N, H, D = 2, 512, 2, 128
    print(f"C1/C2: B3 and B6 at (B, N, H, D) = ({B}, {N}, {H}, {D}), padded keys")
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
    lengths = torch.randint(N // 2, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    compare("flash_attention", fa.flash_attention_packed(qkv, H, bias),
            fa.flash_attention_packed_reference(qkv, H, bias), TOL["flash_attention"], results)
    extra_times("C1: B3 at D = 128, N = 512", lambda: fa.flash_attention_packed(qkv, H, bias),
                lambda: fa.flash_attention_packed_reference(qkv, H, bias),
                4 * B * H * N * N * D, (qkv, bias, fa.flash_attention_packed(qkv, H, bias)),
                sdpa_ms(*heads_of(qkv, H), bias))
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    for kw in ({}, drop):
        want = fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **kw)
        compare_grads("flash_attention_bwd", fa._kernel_bwd(qkv, do, H, bias, **kw), want,
                      "packed", results, H)
    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
    wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
        B, N, 3, H, D)[:, :, 2]
    check(torch.equal(gdv != 0, wdv != 0), "B6 dropout mask at D = 128 differs")
    print(f"  B6 dropout mask at D = 128 equal bit for bit; kept share "
          f"{float((wdv != 0).sum()) / (int((pbias == 0).sum()) * D * H):.4f}")
    extra_times("C2: B6 at D = 128, N = 512, rate 0.1",
                lambda: fa._kernel_bwd(qkv, do, H, bias, **drop),
                lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop),
                10 * B * H * N * N * D,
                (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias, **drop)),
                sdpa_ms(*heads_of(qkv, H), bias, do.view(B, N, H, D).transpose(1, 2)))

    R, HID, F = 12800, 256, 1024
    print(f"C3: B4 and B8 at hidden {HID}: x, dy [{R}, {HID}] bf16, F = {F}")
    x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
    dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
    w1 = (torch.randn(F, HID, device=dev, generator=g) * HID ** -0.5).bfloat16()
    b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(HID, F, device=dev, generator=g) * F ** -0.5).bfloat16()
    b2 = (torch.randn(HID, device=dev, generator=g) * 0.02).bfloat16()
    compare("mlp", mlp.dense_gelu_dense(x, w1, b1, w2, b2),
            mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), TOL["mlp"], results)
    for a_, b_ in zip(mlp._kernel_bwd(x, w1, b1, w2, dy),
                      mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)):
        compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
    extra_times("C3: B4 at hidden 256", lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2),
                lambda: mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), 4 * R * HID * F,
                (x, w1, b1, w2, b2, mlp.dense_gelu_dense(x, w1, b1, w2, b2)))
    mlp_fwd_yardstick("C3: B4 at hidden 256", lambda: mlp.dense_gelu_dense(x, w1, b1, w2, b2),
                      x, w1, w2)
    extra_times("C3: B8 at hidden 256", lambda: mlp._kernel_bwd(x, w1, b1, w2, dy),
                lambda: mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy), 6 * R * HID * F,
                (x, w1, b1, w2, dy) + tuple(mlp._kernel_bwd(x, w1, b1, w2, dy)))
    mlp_bwd_yardstick("C3: B8 at hidden 256", mlp, x, w1, b1, w2, dy)
    blk = mods["mlp_block"]
    for HID, F in ((1280, 5120), (192, 768)):
        print(f"B4, B8 and B9 past the old width bounds: x, dy [{R}, {HID}] bf16, F = {F}")
        x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
        dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
        w1 = (torch.randn(F, HID, device=dev, generator=g) * HID ** -0.5).bfloat16()
        b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
        w2 = (torch.randn(HID, F, device=dev, generator=g) * F ** -0.5).bfloat16()
        b2 = (torch.randn(HID, device=dev, generator=g) * 0.02).bfloat16()
        got = mlp._kernel_bwd(x, w1, b1, w2, dy)
        for a_, b_ in zip(got, mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy)):
            compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
        extra_times(f"B8 at hidden {HID}, F = {F}", lambda: mlp._kernel_bwd(x, w1, b1, w2, dy),
                    lambda: mlp.dense_gelu_dense_bwd_reference(x, w1, b1, w2, dy),
                    6 * R * HID * F, (x, w1, b1, w2, dy) + tuple(got))
        del got
        mlp_bwd_yardstick(f"B8 at hidden {HID}", mlp, x, w1, b1, w2, dy)
        compare("mlp", mlp._kernel(x, w1, b1, w2, b2),
                mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2), TOL["mlp"], results)
        extra_times(f"B4 at hidden {HID}, F = {F}", lambda: mlp._kernel(x, w1, b1, w2, b2),
                    lambda: mlp.dense_gelu_dense_reference(x, w1, b1, w2, b2),
                    4 * R * HID * F, (x, w1, b1, w2, b2, mlp._kernel(x, w1, b1, w2, b2)))
        mlp_fwd_yardstick(f"B4 at hidden {HID}", lambda: mlp._kernel(x, w1, b1, w2, b2),
                          x, w1, w2)
        # B9 through its wrapper's kernel entry: the public function keeps
        # JAX's rule (multiples of 128), which 192 breaks
        ls = 1.0 + 0.1 * torch.randn(HID, device=dev, generator=g)
        lb, fb2 = (0.1 * torch.randn(HID, device=dev, generator=g) for _ in range(2))
        fb1 = 0.1 * torch.randn(F, device=dev, generator=g)
        args = (x, ls, lb, w1, fb1, w2, fb2)
        for approximate in (False, True):
            kw = dict(eps=1e-6, gelu_approximate=approximate)
            want = blk.fused_mlp_block_reference(*args, **kw).float() - x.float()
            compare("mlp_block", blk._kernel(*args, **kw).float() - x.float(), want,
                    TOL["mlp_block_rel"] * float(want.abs().max()), results)
        del want
        kw = dict(eps=1e-6, gelu_approximate=False)
        extra_times(f"B9 at hidden {HID}, F = {F}", lambda: blk._kernel(*args, **kw),
                    lambda: blk.fused_mlp_block_reference(*args, **kw), 4 * R * HID * F,
                    args + (blk._kernel(*args, **kw),))
        mlp_fwd_yardstick(f"B9 at hidden {HID}", lambda: blk._kernel(*args, **kw), x, w1, w2)


def phase2_limits(mods, dev, seed: int, results: dict) -> None:
    """The limits ROADMAP C4-C6 lifted: head dims 32, 96, 160, 256 and 320
    in B3/B5/B6/B7 (held to the plain versions, B5/B7 bit-equal to B3/B6 in
    both layouts, over 128 the dropout masks bit for bit, timed beside
    SDPA), B1 at any width with 200 prompts, and a batch of 65537 through
    B2, B3 and B6."""
    import torch

    fa, sim, prep = mods["flash_attention"], mods["similarity"], mods["image_prep"]
    g = torch.Generator(dev).manual_seed(seed + 8)

    def inputs(B, N, H, D):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
        do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
        lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        return qkv, do, bias, dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))

    B, N = TRAIN_BATCH, TRAIN_LEN
    for D, H, how in ((32, 24, "built"), (96, 8, "zero-padded to 128 by the wrappers"),
                      (160, 8, "zero-padded to 192, in 64-column slices"),
                      (256, 6, "in 64-column slices"), (320, 6, "in 64-column slices")):
        print(f"C4: B3/B5/B6/B7 at head dim {D} ({how}): (B, N, H, D) = {(B, N, H, D)}, "
              "padded keys, rates 0 and 0.1")
        qkv, do, bias, drop = inputs(B, N, H, D)
        for kw in ({}, drop):
            out = fa.flash_attention_packed(qkv, H, bias, **kw)
            compare("flash_attention", out, fa.flash_attention_packed_reference(
                qkv, H, bias, **kw), TOL["flash_attention"], results)
            dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
            compare_grads("flash_attention_bwd", dqkv, fa.flash_attention_packed_bwd_reference(
                qkv, do, H, bias, **kw), "packed", results, H)
            for layout in ("bnhd", "bhnd"):
                q, k, v = split_operands(qkv, H, layout)
                dos = as_bnhd(do.view(B, N, H, D), layout).contiguous()
                split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
                compare("flash_attention_split", split, head_major(fa.flash_attention_reference(
                    *(head_major(t, layout) for t in (q, k, v)), bias, **kw), layout),
                    TOL["flash_attention"], results)
                check(torch.equal(as_bnhd(split, layout).reshape(B, N, H * D), out),
                      f"B5 ({layout}) differs from B3 at D = {D}")
                grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
                for i, (a_, b_) in enumerate(zip(grads, fa.flash_attention_bwd_reference(
                        *(head_major(t, layout) for t in (q, k, v, dos)), bias, **kw))):
                    compare_grads("flash_attention_split_bwd", a_, head_major(b_, layout),
                                  layout, results)
                    check(torch.equal(as_bnhd(a_, layout), dqkv.view(B, N, 3, H, D)[:, :, i]),
                          f"B7 ({layout}) differs from B6 at D = {D}")
        print(f"  B5 and B7 bit-equal to B3 and B6 at D = {D}, both layouts, rates 0 and 0.1")
        if D > 128:  # every slice draws the same mask
            pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
            want = fa.flash_attention_packed_reference(pq, H, pbias, **drop)
            check(torch.equal(fa.flash_attention_packed(pq, H, pbias, **drop) != 0, want != 0),
                  f"B3 dropout mask at D = {D} differs from the plain version's")
            gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
            wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
                B, N, 3, H, D)[:, :, 2]
            check(torch.equal(gdv != 0, wdv != 0),
                  f"B6 dropout mask at D = {D} differs from the plain version's")
            print(f"  dropout masks at D = {D} equal bit for bit in B3's output and B6's dv; "
                  f"kept share {float((want != 0).sum()) / (int((pbias == 0).sum()) * N * H):.4f}")
            del pq, pdo, want, gdv, wdv
        heads = heads_of(qkv, H)
        extra_times(f"C4: B3 at D = {D}, rate 0.1",
                    lambda: fa.flash_attention_packed(qkv, H, bias, **drop),
                    lambda: fa.flash_attention_packed_reference(qkv, H, bias, **drop),
                    4 * B * H * N * N * D,
                    (qkv, bias, drop["dropout_seeds"], fa.flash_attention_packed(qkv, H, bias)),
                    sdpa_ms(*heads, bias))
        extra_times(f"C4: B6 at D = {D}, rate 0.1",
                    lambda: fa._kernel_bwd(qkv, do, H, bias, **drop),
                    lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop),
                    10 * B * H * N * N * D,
                    (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias)),
                    sdpa_ms(*heads, bias, do.view(B, N, H, D).transpose(1, 2)))
        del qkv, do, heads

    for D in (64, 96):
        print(f"C5: B1 at D = {D}: img [{BATCH}, {D}] x txt [200, {D}] fp32, T = 0.5")
        img = torch.randn(BATCH, D, device=dev, generator=g)
        img[-1] = 0.0
        txt = torch.randn(200, D, device=dev, generator=g)
        compare("similarity", sim.similarity(img, txt, 0.5),
                sim.similarity_reference(img, txt, 0.5), TOL["similarity"], results)
        extra_times(f"C5: B1 at D = {D}, C = 200", lambda: sim.similarity(img, txt, 0.5),
                    lambda: sim.similarity_reference(img, txt, 0.5),
                    2 * BATCH * 200 * D + 3 * (BATCH + 200) * D,
                    (img, txt, sim.similarity(img, txt, 0.5)), peak="fp32")
        cos = torch.nn.functional.cosine_similarity
        lib_ms = cuda_ms(lambda: cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5)
        print(f"  yardstick, never called by the port: F.cosine_similarity / T at D = {D}, "
              f"C = 200: {lib_ms:.4f} ms")

    B = 65537
    print(f"C6: a batch of {B}: B2 [{B}, 12, 10, 1] uint8 -> [{B}, 8, 8, 3] bf16; B3 and B6 at "
          f"(B, N, H, D) = ({B}, 5, 2, 32), rate 0.1")
    imgs = torch.randint(0, 256, (B, 12, 10, 1), device=dev, generator=g, dtype=torch.uint8)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    compare("image_prep", prep.preprocess_images(imgs, 8, 8, mean, std),
            prep.preprocess_reference(imgs, 8, 8, mean, std), TOL["image_prep"], results)
    qkv, do, bias, drop = inputs(B, 5, 2, 32)
    compare("flash_attention", fa.flash_attention_packed(qkv, 2, bias, **drop),
            fa.flash_attention_packed_reference(qkv, 2, bias, **drop), TOL["flash_attention"],
            results)
    compare_grads("flash_attention_bwd", fa._kernel_bwd(qkv, do, 2, bias, **drop),
                  fa.flash_attention_packed_bwd_reference(qkv, do, 2, bias, **drop), "packed",
                  results, 2)


def split_operands(qkv, H: int, layout: str):
    """q, k, v of a packed qkv in ``layout``: "bnhd" views of its column
    blocks, or "bhnd" head-major contiguous copies."""
    B, N, _ = qkv.shape
    q, k, v = qkv.view(B, N, 3, H, -1).unbind(2)
    if layout == "bhnd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return q, k, v


def as_bnhd(t, layout: str):
    return t if layout == "bnhd" else t.transpose(1, 2)


def head_major(t, layout: str):
    """A split operand as [B, H, N, D] for the plain versions, and their
    [B, H, N, D] results back in ``layout``."""
    return t if layout == "bhnd" else t.transpose(1, 2)


def phase2_split(_build, mods, dev, seed: int, results: dict) -> dict:
    """B5 and B7 (the split form) against their plain versions and bit-equal
    to B3 and B6, then the split entry point's main path and the layout
    probe P1; returns the launches of both paths."""
    import torch

    from clip_for_dl_tpu_torch.tools import probe_bwd_layouts

    fa = mods["flash_attention"]
    g = torch.Generator(dev).manual_seed(seed + 6)

    def check_shape(B, N, H, D, min_len):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
        do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
        lengths = torch.randint(min_len, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
        for layout in ("bnhd", "bhnd"):
            q, k, v = split_operands(qkv, H, layout)
            dos = as_bnhd(do.view(B, N, H, D), layout).contiguous()
            for kw in ({}, drop):
                out = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
                want = fa.flash_attention_reference(
                    *(head_major(t, layout) for t in (q, k, v)), bias, **kw)
                compare("flash_attention_split", out, head_major(want, layout),
                        TOL["flash_attention"], results)
                check(torch.equal(as_bnhd(out, layout).reshape(B, N, H * D),
                                  fa.flash_attention_packed(qkv, H, bias, **kw)),
                      f"B5 ({layout}) differs from B3 on the same heads")
                grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
                plain = fa.flash_attention_bwd_reference(
                    *(head_major(t, layout) for t in (q, k, v, dos)), bias, **kw)
                packed = fa._kernel_bwd(qkv, do, H, bias, **kw).view(B, N, 3, H, D)
                for i, (a_, b_) in enumerate(zip(grads, plain)):
                    compare_grads("flash_attention_split_bwd", a_, head_major(b_, layout),
                                  layout, results)
                    check(torch.equal(as_bnhd(a_, layout), packed[:, :, i]),
                          f"B7 ({layout}) differs from B6 on the same heads")
        print(f"  B5 and B7 bit-equal to B3 and B6 at {(B, N, H, D)}, both layouts, "
              "rates 0 and 0.1")
        return qkv, do, bias, drop

    B, N, H, D = TRAIN_BATCH, TRAIN_LEN, 12, 64
    print(f"B5/B7 split attention: (B, N, H, D) = {(B, N, H, D)} bf16, padded keys, "
          "layouts bnhd and bhnd, rates 0 and 0.1")
    qkv, do, bias, drop = check_shape(B, N, H, D, 3)

    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    for layout in ("bnhd", "bhnd"):
        q, k, v = split_operands(pq, H, layout)
        dos = as_bnhd(pdo.view(B, N, H, D), layout).contiguous()
        out = as_bnhd(fa.flash_attention(q, k, v, pbias, layout=layout, **drop), layout)
        want = fa.flash_attention_packed_reference(pq, H, pbias, **drop).view(B, N, H, D)
        check(torch.equal(out != 0, want != 0), f"B5 ({layout}) dropout mask differs")
        dv = as_bnhd(fa.flash_attention_bwd(q, k, v, dos, pbias, layout=layout, **drop)[2],
                     layout)
        wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
            B, N, 3, H, D)[:, :, 2]
        check(torch.equal(dv != 0, wdv != 0), f"B7 ({layout}) dropout mask differs")
    print("  B5 and B7 dropout masks equal bit for bit in both layouts")

    q, k, v = split_operands(qkv, H, "bnhd")
    dos = do.view(B, N, H, D)
    out = fa.flash_attention(q, k, v, bias, layout="bnhd", **drop)
    grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop)
    for name, kernel, plain, flops, io in (
        ("flash_attention_split",
         lambda: fa.flash_attention(q, k, v, bias, layout="bnhd", **drop),
         lambda: fa.flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)), bias,
                                              **drop),
         4 * B * H * N * N * D, (q, k, v, bias, drop["dropout_seeds"], out)),
        ("flash_attention_split_bwd",
         lambda: fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop),
         lambda: fa.flash_attention_bwd_reference(
             *(t.transpose(1, 2) for t in (q, k, v, dos)), bias, **drop),
         10 * B * H * N * N * D, (q, k, v, dos, bias, drop["dropout_seeds"]) + tuple(grads)),
    ):
        results[name]["ms"] = cuda_ms(kernel, iters=10)
        results[name]["plain_ms"] = cuda_ms(plain, iters=10)
        set_bound(results, name, flops, io)
        print(f"  {name} (bnhd, rate 0.1): kernel {results[name]['ms']:.4f} ms  "
              f"plain {results[name]['plain_ms']:.4f} ms")
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    results["flash_attention_split"]["library_ms"] = sdpa_ms(*heads, bias)
    results["flash_attention_split_bwd"]["library_ms"] = sdpa_ms(*heads, bias,
                                                                 dos.transpose(1, 2))
    qh, kh, vh = split_operands(qkv, H, "bhnd")
    doh = dos.transpose(1, 2).contiguous()
    fwd_io = (qh, kh, vh, bias, drop["dropout_seeds"], out)
    bwd_io = (qh, kh, vh, doh, bias, drop["dropout_seeds"]) + tuple(grads)
    extra_times("B5 (bhnd, rate 0.1)",
                lambda: fa.flash_attention(qh, kh, vh, bias, layout="bhnd", **drop),
                lambda: fa.flash_attention_reference(qh, kh, vh, bias, **drop),
                4 * B * H * N * N * D, fwd_io, results["flash_attention_split"]["library_ms"])
    extra_times("B7 (bhnd, rate 0.1)",
                lambda: fa.flash_attention_bwd(qh, kh, vh, doh, bias, layout="bhnd", **drop),
                lambda: fa.flash_attention_bwd_reference(qh, kh, vh, doh, bias, **drop),
                10 * B * H * N * N * D, bwd_io, results["flash_attention_split_bwd"]["library_ms"])
    extra_times("B7 (bnhd, rate 0)",
                lambda: fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd"),
                lambda: fa.flash_attention_bwd_reference(
                    *(t.transpose(1, 2) for t in (q, k, v, dos)), bias),
                10 * B * H * N * N * D, (q, k, v, dos, bias) + tuple(grads),
                results["flash_attention_split_bwd"]["library_ms"])
    del qkv, do, pq, pdo, grads, out

    print("B5/B7 at (B, N, H, D) = (2, 512, 2, 128), padded keys")
    check_shape(2, 512, 2, 128, 256)

    by_path = {}
    # -- the split entry point with autograd, counted ------------------------
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    ct = torch.randn(B, N, H, D, device=dev, generator=g).bfloat16()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    for layout in ("bnhd", "bhnd"):
        xs = [t.detach().clone().requires_grad_() for t in split_operands(qkv, H, layout)]
        out = fa.flash_attention(*xs, bias, layout=layout, **drop)
        out.backward(as_bnhd(ct, layout))
        check(all(torch.isfinite(x.grad.float()).all() for x in xs),
              f"non-finite split gradients ({layout})")
    torch.cuda.synchronize(dev)
    by_path["split_attention"] = dict(_build.LAUNCHES)
    print(f"launches on the split_attention path: {by_path['split_attention']}")
    check_launched(mods, by_path["split_attention"], "split_attention")

    # -- the layout probe P1, counted ----------------------------------------
    print("P1 layout probe (tools/probe_bwd_layouts.py, dropout off):")
    _build.reset_launches()
    code = probe_bwd_layouts.main(["--batch", str(B), "--seq", str(N), "--heads", str(H),
                                   "--dim", str(D), "--iters", "30"])
    torch.cuda.synchronize(dev)
    by_path["layout_probe"] = dict(_build.LAUNCHES)
    check(code == 0, "the layout probe found a MISMATCH between B6 and B7's layouts")
    print(f"launches on the layout_probe path: {by_path['layout_probe']}")
    check_launched(mods, by_path["layout_probe"], "layout_probe")
    return by_path

def typed_grads(name, got, want, layout, dtype, results, heads=None):
    """compare_grads at ``dtype``'s per-slice rule (fa.GRAD_TOL)."""
    import torch

    from clip_for_dl_tpu_torch.ops.flash_attention import grad_slice_error

    check(got.dtype == dtype, f"{name}: {got.dtype}, not {dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    max_abs, worst = grad_slice_error(got, want, layout, heads, dtype)
    print(f"  {name}: max_abs {max_abs:.3e}  worst (batch row, head) slice at {worst:.3f} "
          "of its tolerance")
    check(worst <= 1.0, f"{name}: a slice is off by {worst} of its tolerance")
    results.setdefault(name, {})["max_abs_err"] = max(
        max_abs, results.get(name, {}).get("max_abs_err", 0.0))


def phase2_types(mods, dev, seed: int, results: dict) -> None:
    """ROADMAP C7: the fp32 and fp16 instances of B3, B5, B6 and B7 against
    their plain versions (the plain fp32 products in full fp32) at rates 0
    and 0.1 and head dims 32, 64, 128 and 160 (N = 200, padded keys), and
    at N = 512; B5/B7 bit-equal to B3/B6 in both layouts; the dropout masks
    bit for bit; then each instance's times at its main shape beside SDPA
    in its type."""
    import torch

    fa = mods["flash_attention"]
    g = torch.Generator(dev).manual_seed(seed + 9)
    torch.backends.cuda.matmul.allow_tf32 = False

    def inputs(B, N, H, D, dt, min_len=3):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).to(dt)
        do = torch.randn(B, N, H * D, device=dev, generator=g).to(dt)
        lengths = torch.randint(min_len, N + 1, (B, 1), device=dev, generator=g)
        bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
        return qkv, do, bias, dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))

    for tag, dt in (("fp32", torch.float32), ("fp16", torch.float16)):
        fwd, bwd = f"flash_attention_{tag}", f"flash_attention_bwd_{tag}"
        sfwd, sbwd = f"flash_attention_split_{tag}", f"flash_attention_split_bwd_{tag}"
        for B, N, H, D in ((4, 200, 4, 32), (4, 200, 4, 64), (4, 200, 4, 128), (4, 200, 4, 160),
                           (2, 512, 2, 64)):
            print(f"C7: B3/B5/B6/B7 in {tag} at (B, N, H, D) = {(B, N, H, D)}, padded keys, "
                  "rates 0 and 0.1")
            qkv, do, bias, drop = inputs(B, N, H, D, dt)
            for kw in ({}, drop):
                out = fa.flash_attention_packed(qkv, H, bias, **kw)
                want = fa.flash_attention_packed_reference(qkv, H, bias, **kw)
                check(out.dtype == dt, f"B3 {tag} wrote {out.dtype}")
                compare(fwd, out, want, fa.fwd_tolerance(want), results)
                dqkv = fa._kernel_bwd(qkv, do, H, bias, **kw)
                typed_grads(bwd, dqkv, fa.flash_attention_packed_bwd_reference(
                    qkv, do, H, bias, **kw), "packed", dt, results, H)
                for layout in ("bnhd", "bhnd"):
                    q, k, v = split_operands(qkv, H, layout)
                    dos = as_bnhd(do.view(B, N, H, D), layout).contiguous()
                    split = fa.flash_attention(q, k, v, bias, layout=layout, **kw)
                    want = head_major(fa.flash_attention_reference(
                        *(head_major(t, layout) for t in (q, k, v)), bias, **kw), layout)
                    compare(sfwd, split, want, fa.fwd_tolerance(want), results)
                    check(torch.equal(as_bnhd(split, layout).reshape(B, N, H * D), out),
                          f"B5 {tag} ({layout}) differs from B3 at {(B, N, H, D)}")
                    grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout=layout, **kw)
                    plain = fa.flash_attention_bwd_reference(
                        *(head_major(t, layout) for t in (q, k, v, dos)), bias, **kw)
                    for i, (a_, b_) in enumerate(zip(grads, plain)):
                        typed_grads(sbwd, a_, head_major(b_, layout), layout, dt, results)
                        check(torch.equal(as_bnhd(a_, layout), dqkv.view(B, N, 3, H, D)[:, :, i]),
                              f"B7 {tag} ({layout}) differs from B6 at {(B, N, H, D)}")
            print(f"  B5 and B7 bit-equal to B3 and B6 in {tag}, both layouts, rates 0 and 0.1")
            if N == 200 and D in (64, 160):
                pq, pdo, pbias = (t.to(dt) if t.is_floating_point() and t.dim() == 3 else t
                                  for t in dropout_probe(B, N, H, D, dev))
                want = fa.flash_attention_packed_reference(pq, H, pbias, **drop)
                check(torch.equal(fa.flash_attention_packed(pq, H, pbias, **drop) != 0, want != 0),
                      f"B3 {tag} dropout mask at D = {D} differs from the plain version's")
                gdv = fa._kernel_bwd(pq, pdo, H, pbias, **drop).view(B, N, 3, H, D)[:, :, 2]
                wdv = fa.flash_attention_packed_bwd_reference(pq, pdo, H, pbias, **drop).view(
                    B, N, 3, H, D)[:, :, 2]
                check(torch.equal(gdv != 0, wdv != 0),
                      f"B6 {tag} dropout mask at D = {D} differs from the plain version's")
                q, k, v = split_operands(pq, H, "bnhd")
                sp = fa.flash_attention(q, k, v, pbias, layout="bnhd", **drop)
                check(torch.equal(sp.reshape(want.shape) != 0, want != 0),
                      f"B5 {tag} dropout mask at D = {D} differs")
                print(f"  dropout masks in {tag} at D = {D} equal bit for bit in B3's and B5's "
                      f"output and B6's dv; kept share "
                      f"{float((want != 0).sum()) / (int((pbias == 0).sum()) * N * H):.4f}")

        # the main shapes: fp32 the parity mode's prompt bank and its
        # phase-A batch (16); fp16 those of bf16's rows
        peak = tag
        fB, bB = (64, 16) if tag == "fp32" else (64, TRAIN_BATCH)
        N, H, D = TRAIN_LEN, 12, 64
        qkv, _, bias, _ = inputs(fB, N, H, D, dt)
        results[fwd]["ms"] = cuda_ms(lambda: fa.flash_attention_packed(qkv, H, bias), iters=10)
        results[fwd]["plain_ms"] = cuda_ms(
            lambda: fa.flash_attention_packed_reference(qkv, H, bias), iters=10)
        set_bound(results, fwd, 4 * fB * H * N * N * D,
                  (qkv, bias, fa.flash_attention_packed(qkv, H, bias)), peak)
        results[fwd]["library_ms"] = sdpa_ms(*heads_of(qkv, H), bias)
        qkv, do, bias, drop = inputs(bB, N, H, D, dt)
        results[bwd]["ms"] = cuda_ms(lambda: fa._kernel_bwd(qkv, do, H, bias, **drop), iters=5)
        results[bwd]["plain_ms"] = cuda_ms(
            lambda: fa.flash_attention_packed_bwd_reference(qkv, do, H, bias, **drop), iters=5)
        set_bound(results, bwd, 10 * bB * H * N * N * D,
                  (qkv, do, bias, drop["dropout_seeds"], fa._kernel_bwd(qkv, do, H, bias, **drop)),
                  peak)
        heads = heads_of(qkv, H)
        results[bwd]["library_ms"] = sdpa_ms(*heads, bias, do.view(bB, N, H, D).transpose(1, 2))
        q, k, v = split_operands(qkv, H, "bnhd")
        dos = do.view(bB, N, H, D)
        out = fa.flash_attention(q, k, v, bias, layout="bnhd", **drop)
        grads = fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop)
        for name, kernel, plain, flops, io in (
            (sfwd, lambda: fa.flash_attention(q, k, v, bias, layout="bnhd", **drop),
             lambda: fa.flash_attention_reference(*(t.transpose(1, 2) for t in (q, k, v)), bias,
                                                  **drop),
             4 * bB * H * N * N * D, (q, k, v, bias, drop["dropout_seeds"], out)),
            (sbwd, lambda: fa.flash_attention_bwd(q, k, v, dos, bias, layout="bnhd", **drop),
             lambda: fa.flash_attention_bwd_reference(
                 *(t.transpose(1, 2) for t in (q, k, v, dos)), bias, **drop),
             10 * bB * H * N * N * D, (q, k, v, dos, bias, drop["dropout_seeds"]) + tuple(grads)),
        ):
            results[name]["ms"] = cuda_ms(kernel, iters=5)
            results[name]["plain_ms"] = cuda_ms(plain, iters=5)
            set_bound(results, name, flops, io, peak)
        results[sfwd]["library_ms"] = sdpa_ms(*heads, bias)
        results[sbwd]["library_ms"] = results[bwd]["library_ms"]
        for name in (fwd, bwd, sfwd, sbwd):
            r = results[name]
            print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                  f"bound {r['bound_ms']:.4f} ms  SDPA {r['library_ms']:.4f} ms")
        del qkv, do, q, k, v, dos, out, grads, heads


def direct_equals_staged(prep, dev, g) -> None:
    """The direct body gives the staged body's bits where both run: both C
    entries on the same uint8 and fp32 images, each output type."""
    import torch

    from clip_for_dl_tpu_torch.ops import _build

    for src, staged in ((torch.uint8, prep.KERNEL), (torch.float32, prep.KERNEL_F32SRC)):
        for shape in ((2, 333, 97, 3), (3, 512, 512, 1)):
            imgs = (torch.randint(0, 256, shape, device=dev, generator=g, dtype=torch.uint8)
                    if src == torch.uint8 else torch.rand(shape, device=dev, generator=g))
            B, H, W, C = shape
            ty, tx = prep._device_taps(H, 224, dev), prep._device_taps(W, 224, dev)
            scale, bias = prep._device_scale_bias(
                (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711),
                1 / 255 if src == torch.uint8 else 1.0, dev)
            for out_t in (torch.float32, torch.bfloat16, torch.float16):
                outs = [torch.empty(B, 224, 224, 3, dtype=out_t, device=dev) for _ in range(2)]
                for o, entry, extra in ((outs[0], staged, ()),
                                        (outs[1], prep.KERNEL_DIRECT,
                                         (int(src != torch.uint8),))):
                    _build.launch(entry, dev, imgs.data_ptr(), *(t.data_ptr() for t in ty + tx),
                                  scale.data_ptr(), bias.data_ptr(), o.data_ptr(), B, H, W, C,
                                  224, 224, 3, prep.OUT_TYPES[out_t], *extra)
                check(torch.equal(outs[0], outs[1]),
                      f"B2's direct body differs from the staged body at {shape} {src} -> {out_t}")
    print("  B2's direct body bit-equal to the staged body (uint8 and fp32 sources, fp32, bf16 "
          "and fp16 outputs)")


def phase2_c8(_build, mods, dev, seed: int, results: dict) -> dict:
    """ROADMAP C8: B1 on bf16, fp16 and mixed features; B2 on fp32 and bf16
    images, writing fp16 and fp64, on rows too wide to stage (the direct
    body, bit-equal to the staged one where both run), and on views; each
    against its plain version, timed at the serving shapes; then the
    c8_cases path (the public functions on those inputs), counted."""
    import torch

    sim, prep = mods["similarity"], mods["image_prep"]
    g = torch.Generator(dev).manual_seed(seed + 10)
    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    cos = torch.nn.functional.cosine_similarity

    print(f"C8: B1 on bf16 and fp16 features: img [{BATCH}, 512] x txt [16, 512], T = 0.5")
    img32 = torch.randn(BATCH, 512, device=dev, generator=g)
    img32[-1] = 0.0
    txt32 = torch.randn(16, 512, device=dev, generator=g)
    for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
        name = f"similarity_{tag}"
        img, txt = img32.to(dt), txt32.to(dt)
        compare(name, sim.similarity(img, txt, 0.5), sim.similarity_reference(img, txt, 0.5),
                TOL["similarity"], results)
        for a, b in ((img32, txt), (img, txt32)):  # each side on its own
            compare(name, sim.similarity(a, b, 0.5), sim.similarity_reference(a, b, 0.5),
                    TOL["similarity"], results)
        r = results[name]
        r["ms"] = cuda_ms(lambda: sim.similarity(img, txt, 0.5))
        r["plain_ms"] = cuda_ms(lambda: sim.similarity_reference(img, txt, 0.5))
        r["library_ms"] = cuda_ms(lambda: cos(img[:, None], txt[None], dim=-1, eps=1e-12) / 0.5)
        set_bound(results, name, 2 * BATCH * 16 * 512 + 3 * (BATCH + 16) * 512,
                  (img, txt, sim.similarity(img, txt, 0.5)), "fp32")
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"F.cosine_similarity in {tag} {r['library_ms']:.4f} ms; device ms a call "
              f"(torch.profiler) "
              f"{kernel_device_ms(lambda: sim.similarity(img, txt, 0.5), ('similarity',))}")
    views = (img32.T.contiguous().T, txt32[:, ::1].T.contiguous().T)
    check(not views[0].is_contiguous(), "the B1 view case is contiguous")
    compare("similarity", sim.similarity(*views, 0.5), sim.similarity_reference(*views, 0.5),
            TOL["similarity"], results)
    print("  B1 on transposed (non-contiguous) views: copied, matches")

    print(f"C8: B2 on fp32 and bf16 images [{BATCH}, 512, 512, 1] in [0, 1] -> bf16 and fp32; "
          "fp16 output of the uint8 batch; rows too wide to stage; views")
    grey = torch.randint(0, 256, (BATCH, 512, 512, 1), device=dev, generator=g,
                         dtype=torch.uint8)
    fimgs = torch.rand(BATCH, 512, 512, 1, device=dev, generator=g)
    for imgs in (fimgs, fimgs.bfloat16()):
        compare("image_prep_f32src", prep.preprocess_images(imgs, 224, 224, mean, std),
                prep.preprocess_reference(imgs, 224, 224, mean, std), TOL["image_prep"],
                results)
        compare("image_prep_f32src",
                prep.preprocess_images(imgs, 224, 224, mean, std, torch.float32),
                prep.preprocess_reference(imgs, 224, 224, mean, std, torch.float32),
                TOL["image_prep_f32"], results)
    r = results["image_prep_f32src"]
    r["ms"] = cuda_ms(lambda: prep.preprocess_images(fimgs, 224, 224, mean, std))
    r["plain_ms"] = cuda_ms(lambda: prep.preprocess_reference(fimgs, 224, 224, mean, std))
    out = prep.preprocess_images(fimgs, 224, 224, mean, std)
    set_bound(results, "image_prep_f32src", 10 * out.numel(), (fimgs, out), "fp32")
    prep_yardstick(prep, fimgs, out, mean, std, r["ms"])
    for imgs in (grey, fimgs):
        compare("image_prep_fp16",
                prep.preprocess_images(imgs, 224, 224, mean, std, torch.float16),
                prep.preprocess_reference(imgs, 224, 224, mean, std, torch.float16),
                TOL["image_prep_f16"], results)
    wide64 = prep.preprocess_images(grey[:8], 224, 224, mean, std, torch.float64)
    check(wide64.dtype == torch.float64 and torch.equal(
        wide64, prep.preprocess_images(grey[:8], 224, 224, mean, std, torch.float32).double()),
        "B2's fp64 output is not its fp32 output cast")
    r = results["image_prep_fp16"]
    r["ms"] = cuda_ms(lambda: prep.preprocess_images(grey, 224, 224, mean, std, torch.float16))
    r["plain_ms"] = cuda_ms(
        lambda: prep.preprocess_reference(grey, 224, 224, mean, std, torch.float16))
    out = prep.preprocess_images(grey, 224, 224, mean, std, torch.float16)
    set_bound(results, "image_prep_fp16", 10 * out.numel(), (grey, out), "fp32")
    del fimgs, out

    # a row pair past shared memory at one output column: 30000 uint8
    # channels (60 KB), and 8000 fp32 ones (64 KB)
    wstats = tuple(0.1 + 0.8 * (i % 7) / 7 for i in range(30000))
    wstd = tuple(0.2 + 0.1 * (i % 3) for i in range(30000))
    wide = torch.randint(0, 256, (4, 12, 10, 30000), device=dev, generator=g, dtype=torch.uint8)
    wide32 = torch.rand(4, 12, 10, 8000, device=dev, generator=g)
    check(prep.needs_direct(10, 6, 30000, 1) and prep.needs_direct(10, 6, 8000, 4),
          "the wide rows would be staged")
    for imgs, c in ((wide, 30000), (wide32, 8000)):
        for out_t, tol in ((torch.bfloat16, TOL["image_prep"]),
                           (torch.float32, TOL["image_prep_f32"])):
            compare("image_prep_direct",
                    prep.preprocess_images(imgs, 6, 6, wstats[:c], wstd[:c], out_t),
                    prep.preprocess_reference(imgs, 6, 6, wstats[:c], wstd[:c], out_t), tol,
                    results)
    r = results["image_prep_direct"]
    print("  B2's direct body at [4, 12, 10, 30000] uint8 -> [4, 6, 6, 30000] bf16, device ms a "
          "call (torch.profiler) " + str(kernel_device_ms(
              lambda: prep.preprocess_images(wide, 6, 6, wstats, wstd), ("image_prep",))))
    r["ms"] = cuda_ms(lambda: prep.preprocess_images(wide, 6, 6, wstats, wstd))
    r["plain_ms"] = cuda_ms(lambda: prep.preprocess_reference(wide, 6, 6, wstats, wstd))
    out = prep.preprocess_images(wide, 6, 6, wstats, wstd)
    set_bound(results, "image_prep_direct", 10 * out.numel(), (wide, out), "fp32")
    direct_equals_staged(prep, dev, g)
    crop = grey[:16, 20:500, 10:490]
    perm = torch.rand(8, 3, 240, 200, device=dev, generator=g).permute(0, 2, 3, 1)
    for imgs in (crop, perm):
        check(not imgs.is_contiguous(), "the B2 view case is contiguous")
        compare("image_prep", prep.preprocess_images(imgs, 224, 224, mean, std),
                prep.preprocess_reference(imgs, 224, 224, mean, std), TOL["image_prep"],
                results)
    print("  B2 on a cropped uint8 view and a permuted fp32 NCHW tensor: copied, matches")
    for name in ("image_prep_f32src", "image_prep_fp16", "image_prep_direct"):
        r = results[name]
        print(f"  {name}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms")

    # -- the c8_cases path: the public functions on those inputs, counted ----
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    for dt in (torch.bfloat16, torch.float16):
        sim.similarity(img32.to(dt), txt32.to(dt), 0.5)
    prep.preprocess_images(grey[:8].float() / 255.0, 224, 224, mean, std)
    prep.preprocess_images(grey[:8], 224, 224, mean, std, torch.float16)
    prep.preprocess_images(wide, 6, 6, wstats, wstd)
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    print(f"launches on the c8_cases path: {launches}")
    check_launched(mods, launches, "c8_cases")
    return launches


def typed_attention_path(_build, mods, dev, seed: int) -> dict:
    """The attention entry points with autograd in the types no preset runs:
    packed and split (both layouts) in fp16, split in fp32; counted."""
    import torch

    fa = mods["flash_attention"]
    g = torch.Generator(dev).manual_seed(seed + 11)
    B, N, H, D = 16, TRAIN_LEN, 12, 64
    lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    for dt in (torch.float16, torch.float32):
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).to(dt)
        ct = torch.randn(B, N, H, D, device=dev, generator=g).to(dt)
        if dt == torch.float16:
            x = qkv.clone().requires_grad_()
            fa.flash_attention_packed(x, H, bias, **drop).backward(ct.reshape(B, N, H * D))
            check(bool(torch.isfinite(x.grad.float()).all()), "non-finite fp16 packed gradient")
        for layout in ("bnhd", "bhnd"):
            xs = [t.detach().clone().requires_grad_() for t in split_operands(qkv, H, layout)]
            fa.flash_attention(*xs, bias, layout=layout, **drop).backward(as_bnhd(ct, layout))
            check(all(torch.isfinite(t.grad.float()).all() for t in xs),
                  f"non-finite {dt} split gradients ({layout})")
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    print(f"launches on the typed_attention path: {launches}")
    check_launched(mods, launches, "typed_attention")
    return launches


def serve_fp32_phase(_build, mods, dev, seed: int, card: str) -> dict:
    """The parity mode's zero-shot path (--fp32 --flash-attention): the
    zero_shot model in fp32 with flash attention encodes the prompt bank and
    scores a batch through the fp32 attention kernels, held against the
    same model on the plain route (B2 kept, so the images are the same)."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        cfg, engine = build_engine(dev, seed, "serve_fp32")
        print(f"model: {describe(cfg)}; fp32 weights and compute, flash attention; built in "
              f"{time.perf_counter() - t0:.1f} s")
        prompts = prompts_for_family("prediction", DISEASE_LABELS)
        images = grey_images(np.random.default_rng(seed + 12), BATCH)
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t = time.perf_counter()
        engine.build_text_features(prompts)
        probs = engine.probs(images)
        torch.cuda.synchronize(dev)
        launches = dict(_build.LAUNCHES)
        print(f"  prompt bank and a batch of {BATCH} in {time.perf_counter() - t:.2f} s on "
              f"{card}; launches {launches}")
        check(probs.shape == (BATCH, 16) and bool(np.isfinite(probs).all()),
              "fp32 probabilities")
        check_launched(mods, launches, "serve_fp32")
        with plain_kernels(mods, keep=("image_prep",)):
            before = dict(_build.LAUNCHES)
            plain = ZeroShotEngine(engine.model, engine.tokenizer, engine.disease_list,
                                   engine.config, engine.mean, engine.std, engine.image_size,
                                   engine.max_text_length, engine.compute_dtype)
            plain.build_text_features(prompts)
            plain_probs = plain.probs(images)
            check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL),
                  "a kernel other than B2 ran during the plain run")
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    feat_err = float((engine.text_features - plain.text_features).abs().max())
    probs_err = float(np.abs(probs - plain_probs).max())
    print(f"  kernels vs plain route in fp32: text features max_abs {feat_err:.3e} (tol "
          f"{TOL['fp32_features']:.0e}); probs max_abs {probs_err:.3e} (tol "
          f"{TOL['fp32_probs']:.0e}); probs std over images {float(probs.std(0).mean()):.3e}")
    check(feat_err <= TOL["fp32_features"], "fp32 text features differ from the plain route")
    check(probs_err <= TOL["fp32_probs"], "fp32 probabilities differ from the plain route")
    return launches


def train_fp32_phase(_build, mods, dev, seed: int) -> dict:
    """One phase-A step of pretrain_clip in fp32 with flash attention at the
    preset's own batch (16), dropout 0, against the same step on the plain
    route from the same weights: the loss within 1e-5 relative, each
    parameter group's gradient cosine ≥ 0.9999."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    preset, cfg, model = train_model(dev, seed, "pretrain_clip", torch.float32)
    B = preset.data.batch_size
    groups = [g.name for g in preset.train.groups]
    label_fn = make_label_fn(groups)
    batch = train_batch(np.random.default_rng(seed + 13), tokenizer(), dev, B, TRAIN_LEN)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step():
        model.load_state_dict(init)
        opt, step = pretrain_step(model, preset, cfg, torch.float32)
        loss = float(step(TrainState(model, opt), batch, base_lrs(preset))[1]["loss"])
        return loss, group_grads(model, label_fn)

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        loss_k, grads_k = one_step()
        torch.cuda.synchronize(dev)
        launches = dict(_build.LAUNCHES)
        with plain_kernels(mods, keep=("image_prep",)):
            loss_p, grads_p = one_step()
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  one fp32 step at B = {B}: loss {loss_k:.8f} with the kernels, {loss_p:.8f} on the "
          f"plain route (rel {rel:.2e}, tol {TOL['fp32_loss_rel']:.0e}); launches {launches}")
    check(np.isfinite(loss_k) and rel <= TOL["fp32_loss_rel"],
          "the fp32 step's loss differs from the plain route's")
    compare_groups("fp32 step", grads_k, grads_p, groups, TOL["fp32_grad_cos"])
    check_launched(mods, launches, "train_fp32")
    return launches


# the entries through which the wrappers launch the kernels of the main
# paths: (module, entry, its plain version, the kernels line's name)
ENTRIES = (
    ("similarity", "_kernel", "similarity_reference", "similarity"),
    ("image_prep", "_kernel", "preprocess_reference", "image_prep"),
    ("flash_attention", "_kernel", "flash_attention_packed_reference", "flash_attention"),
    ("flash_attention", "_kernel_bwd", "flash_attention_packed_bwd_reference",
     "flash_attention_bwd"),
    ("mlp_train", "_kernel", "dense_gelu_dense_reference", "mlp"),
    ("mlp_train", "_kernel_bwd", "dense_gelu_dense_bwd_reference", "mlp_bwd"),
    ("mlp_block", "_kernel", "fused_mlp_block_reference", "mlp_block"),
)


def plain_kernels(mods, keep=()):
    """Test-only substitution: every kernel entry, forward and backward,
    replaced by its plain version, as phase 2 calls it (the wrappers' own
    dispatch is untouched); the modules named in ``keep`` keep theirs."""
    stack = ExitStack()
    for module, entry, plain, _ in ENTRIES:
        if module not in keep:
            stack.enter_context(mock.patch.object(mods[module], entry,
                                                  getattr(mods[module], plain)))
    return stack


def first_inputs(mods, which: dict):
    """Test-only patches that keep a copy of the inputs of one call of each
    kernel named in ``which`` (the kernels line's names): the first call,
    or the first for which ``which[name](args, kwargs)`` is true. Every call
    goes on to the kernel. Returns (the patches, name -> (args, kwargs))."""
    import torch

    def clone(x):
        return x.detach().clone() if torch.is_tensor(x) else x

    kept, stack = {}, ExitStack()
    for module, entry, _, name in ENTRIES:
        if name not in which:
            continue

        def keep(*a, _name=name, _kernel=getattr(mods[module], entry), **kw):
            wanted = which[_name]
            if _name not in kept and (wanted is None or wanted(a, kw)):
                kept[_name] = (tuple(map(clone, a)), {k: clone(v) for k, v in kw.items()})
            return _kernel(*a, **kw)

        stack.enter_context(mock.patch.object(mods[module], entry, keep))
    return stack, kept


def hold_first_inputs(mods, kept: dict, which, where: str, results: dict) -> None:
    """Each kernel that first_inputs kept against its plain version on the
    same tensors, at its phase-2 tolerance (B6 per (batch row, head) slice,
    B8 and B9 relative to each output's largest entry; B2 at its output
    dtype's: one bf16 or fp16 step, or image_prep_f32; the fp32 and fp16
    instances of B3 and B6 at their type's rule, as phase 2 holds them)."""
    import torch

    check(set(kept) == set(which), f"{where}: kept the inputs of {sorted(kept)}, not of "
                                   f"{sorted(which)}")
    fa, mlp, blk = mods["flash_attention"], mods["mlp_train"], mods["mlp_block"]
    type_tag = {torch.float32: "_fp32", torch.float16: "_fp16"}
    for name in sorted(kept):
        a, kw = kept[name]
        shapes = " ".join(str(list(t.shape)) for t in a if torch.is_tensor(t))
        rate = f", dropout {kw['dropout_rate']}" if kw.get("dropout_rate") else ""
        print(f"  {name} at {where}'s inputs {shapes} {a[0].dtype}{rate}:")
        if name == "image_prep":
            prep = mods["image_prep"]
            got = prep._kernel(*a, **kw)
            tol = {torch.float32: "image_prep_f32", torch.float16: "image_prep_f16"}.get(
                got.dtype, name)
            compare(name, got, prep.preprocess_reference(*a, **kw), TOL[tol], results)
        elif name == "similarity":
            sim = mods["similarity"]
            compare(name, sim._kernel(*a, **kw), sim.similarity_reference(*a, **kw), TOL[name],
                    results)
        elif name == "flash_attention" and a[0].dtype != torch.bfloat16:
            # the fp32 and fp16 instances at their type's rule, as phase 2 (C7)
            want = fa.flash_attention_packed_reference(*a, **kw)
            compare(name + type_tag[a[0].dtype], fa._kernel(*a, **kw), want,
                    fa.fwd_tolerance(want), results)
        elif name == "flash_attention_bwd" and a[0].dtype != torch.bfloat16:
            typed_grads(name + type_tag[a[0].dtype], fa._kernel_bwd(*a, **kw),
                        fa.flash_attention_packed_bwd_reference(*a, **kw), "packed", a[0].dtype,
                        results, a[2])
        elif name == "flash_attention":
            compare(name, fa._kernel(*a, **kw), fa.flash_attention_packed_reference(*a, **kw),
                    TOL[name], results)
        elif name == "flash_attention_bwd":
            compare_grads(name, fa._kernel_bwd(*a, **kw),
                          fa.flash_attention_packed_bwd_reference(*a, **kw), "packed", results,
                          a[2])
        elif name == "mlp":  # the tanh form's row when the call took it
            compare(name + "_tanh" * bool(a[5:6] and a[5]), mlp._kernel(*a),
                    mlp.dense_gelu_dense_reference(*a), TOL[name], results)
        elif name == "mlp_bwd":
            for part, got, want in zip(("dx", "g", "dh"), mlp._kernel_bwd(*a),
                                       mlp.dense_gelu_dense_bwd_reference(*a)):
                print(f"    {part}:", end="")
                compare(name + "_tanh" * bool(a[5:6] and a[5]), got, want,
                        TOL["bwd_rel"] * float(want.float().abs().max()), results)
        else:  # B9: its MLP branch out - x, as check_mlp_block holds it
            x = a[0].float()
            want = blk.fused_mlp_block_reference(*a, **kw).float() - x
            compare(name, blk._kernel(*a, **kw).float() - x, want,
                    TOL["mlp_block_rel"] * float(want.abs().max()), results)


def describe(cfg) -> str:
    if cfg.image_tower == "vit_b16":
        image = (f"ViT-B/{cfg.vit_patch} {cfg.vit_layers}x{cfg.vit_hidden}, {cfg.vit_heads} "
                 f"heads, MLP {cfg.vit_mlp_dim} (fused block: {cfg.vit_fused_mlp})")
    else:
        image = f"ResNet-50 {cfg.resnet_stages}"
    return (f"{image} + BERT {cfg.text_layers}x{cfg.text_embedding_dim} vocab "
            f"{cfg.vocab_size} + heads {cfg.shared_embedding_dim}")


def serve_phase(_build, mods, dev, seed: int, batch: int, n_batches: int, card: str,
                path: str) -> dict:
    """Phases 3 and 5: the zero-shot engine and service over ``path``'s
    model (``tools/main_paths.py`` SERVE_MODELS)."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.serving import ZeroShotService
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t0 = time.perf_counter()
    cfg, engine = build_engine(dev, seed, path)
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"model: {describe(cfg)}; {n_params / 1e6:.1f} M params, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = prompts_for_family("prediction", DISEASE_LABELS)
    rng = np.random.default_rng(seed)
    host_batches = [grey_images(rng, batch) for _ in range(2)]
    requests = rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)

    # -- the main path, counted ------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    engine.build_text_features(prompts)
    probs = engine.probs(host_batches[0])
    streamed = list(engine.stream_logits(
        {"images": host_batches[i % 2], "i": i} for i in range(n_batches)))
    service = ZeroShotService(engine, DISEASE_LABELS)
    try:
        answers = [service.predict_one(im, timeout_s=120.0) for im in requests]
    finally:
        service.close()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"launches on the main path: {launches}")
    print(f"peak device memory on the main path: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; single requests "
          f"answered in {[a['latency_ms'] for a in answers]} ms")

    check(engine.text_features.shape == (16, cfg.shared_embedding_dim),
          f"text features {tuple(engine.text_features.shape)}")
    check(probs.shape == (batch, 16), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()) and probs.min() >= 0.0 and probs.max() <= 1.0,
          "probabilities not finite in [0, 1]")
    check([b["i"] for b, _ in streamed] == list(range(n_batches)), "stream order")
    for b, logits in streamed:
        check(logits.shape == (batch, 16) and bool(np.isfinite(logits).all()),
              "streamed logits")
    np.testing.assert_allclose(streamed[0][1], engine.logits(host_batches[0]), atol=1e-6)
    service_err = 0.0
    for im, ans in zip(requests, answers):
        want = engine.probs(im[None])[0]
        got = np.array([ans["probs"][d] for d in DISEASE_LABELS])
        service_err = max(service_err, float(np.abs(got - want).max()))
    print(f"service vs engine.probs: max_abs {service_err:.3e}  tol {TOL['service']:.1e}")
    check(service_err <= TOL["service"], "service answers differ from engine.probs")
    check_launched(mods, launches, path)

    # -- the same model with every kernel replaced by its plain version -------
    with plain_kernels(mods):
        before = dict(_build.LAUNCHES)
        plain_engine = ZeroShotEngine(
            engine.model, engine.tokenizer, engine.disease_list, engine.config,
            engine.mean, engine.std, engine.image_size, engine.max_text_length,
            engine.compute_dtype,
        )
        plain_engine.build_text_features(prompts)
        plain_probs = plain_engine.probs(host_batches[0])
        check(dict(_build.LAUNCHES) == before, "a kernel ran during the plain run")
    cos = torch.nn.functional.cosine_similarity(
        engine.text_features, plain_engine.text_features, dim=-1)
    probs_err = float(np.abs(probs - plain_probs).max())
    print(f"kernels vs plain versions: text-feature cosine min {float(cos.min()):.6f}; "
          f"probs max_abs {probs_err:.3e}  tol {TOL['probs_vs_plain']:.1e}; "
          f"probs std over images {float(probs.std(0).mean()):.3e}, "
          f"over classes {float(probs.std(1).mean()):.3e}")
    check(probs_err <= TOL["probs_vs_plain"], "engine probabilities differ from plain")

    # -- rates -----------------------------------------------------------------
    def e2e():
        for _ in engine.stream_logits({"images": host_batches[i % 2]} for i in range(n_batches)):
            pass

    e2e()
    torch.cuda.synchronize()
    t = time.perf_counter()
    e2e()
    torch.cuda.synchronize()
    e2e_rate = n_batches * batch / (time.perf_counter() - t)
    dev_images = torch.from_numpy(host_batches[0]).to(dev)
    ms = cuda_ms(lambda: engine._logits(dev_images), warmup=2, iters=10)
    device_rate = batch / (ms / 1e3)
    print(f"image path, batch {batch} of 512x512 grey uint8, on {card}: "
          f"{e2e_rate:.1f} img/s host uint8 -> logits (stream_logits); "
          f"{device_rate:.1f} img/s uint8 on the card -> logits ({ms:.3f} ms/batch)")
    return launches


def tensor_core_counts(_build) -> dict:
    """Kernel (mangled name) -> [its HMMA, its HGMMA instructions] in the
    built library's SASS, from the cuobjdump beside nvcc."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", _build.build_info["path"]], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "HMMA" in line
            counts[name][1] += "HGMMA" in line
    return counts


def check_launched(mods, launches: dict, path: str) -> None:
    for name in PATHS[path]:
        key = KERNELS[name][0]
        check(launches.get(key, 0) > 0, f"kernel {name} ({key}) never launched by the "
              f"{path} path")


CALIBRATION = ("logit_scale", "logit_bias")  # a learnable temperature's scalars


def group_grads(model, label_fn) -> dict:
    """label -> every gradient of the group (zeros where there is none),
    flattened into one fp32 vector; a learnable temperature's scalars each
    under its own name, apart from the default group's heads."""
    import torch

    parts: dict = {}
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        label = name if name in CALIBRATION else label_fn(tuple(name.split(".")))
        parts.setdefault(label, []).append(g.float().flatten())
    return {k: torch.cat(v) for k, v in parts.items()}


def cosine(a, b) -> float:
    import torch

    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def compare_groups(what: str, got: dict, want: dict, groups, tol) -> None:
    """Each group's gradient cosine at least ``tol`` (one bound, or a dict
    group -> bound); the groups not in ``groups`` zero in both."""
    for label in sorted(want):
        gk, gp = got[label], want[label]
        if label not in groups:  # heads the pretrain forward skips
            check(not gk.any() and not gp.any(), f"{what}: {label} gradients not zero")
            print(f"  {label}: zero gradients in both ({gk.numel()} parameters)")
            continue
        bound = tol[label] if isinstance(tol, dict) else tol
        cos = cosine(gk, gp)
        print(f"  {label}: gradient cosine {cos:.6f}  norms {float(gk.norm()):.4e} / "
              f"{float(gp.norm()):.4e}  tol {bound}")
        check(cos >= bound, f"{what}: {label} gradient differs from the plain version's")


@contextmanager
def fp32_compute(model):
    """Test-only: the fp32 route of a model built with cast_in_forward (its
    casts to fp32, TF32 off in matmuls and cuDNN) while inside."""
    import torch

    from clip_for_dl_tpu_torch.core import device

    casts = [m for m in model.modules() if isinstance(m, device._Cast)]
    dtypes = [c.dtype for c in casts]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for c in casts:
        c.dtype = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        for c, dtype in zip(casts, dtypes):
            c.dtype = dtype
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def first_step_routes(_build, mods, first: dict, label_fn, step32=None,
                      encode_bank=None, cast_model=None) -> dict:
    """The first step a command took, from the weights, optimizer state and
    generator state that step started from, on the batch it took, at
    dropout 0: route -> (loss, group_grads). "kernels" and "plain" (their
    plain versions, B2 kept, as in phase 4) run the command's step; given
    ``step32``, the same step in fp32, "kernels_fp32" and "plain_fp32" run
    that on the model's fp32 route (fp32_compute). Given ``encode_bank``
    (the multi-view step), each route first encodes the prompt bank from
    those weights on its own route, ``encode_bank(model)``, and passes it
    as the step's first argument after the batch; the banks are kept
    under ``"banks"``. ``cast_model`` is the model whose casts the fp32
    route flips when it is not the state's (LoRA's frozen model)."""
    import torch

    from clip_for_dl_tpu_torch.train import TrainState

    model, opt = first["state"].model, first["state"].optimizer
    banks = {}

    def one_step(step, route):
        model.load_state_dict(first["weights"])
        opt.load_state_dict(first["optimizer"])
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        rest = first["rest"]
        if encode_bank is not None:
            banks[route] = encode_bank(model)
            rest = (banks[route], *rest[1:])
        if first["generator"] is not None:
            rest[-1].set_state(first["generator"])
        out = step(TrainState(model, opt), first["batch"], *rest)
        return float(out[1]["loss"]), group_grads(model, label_fn)

    def plain(step, route):
        with plain_kernels(mods, keep=("image_prep",)):
            before = dict(_build.LAUNCHES)
            out = one_step(step, route)
            check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL),
                  "a kernel other than B2 ran during the plain step")
        return out

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        routes = {"kernels": one_step(first["step"], "kernels"),
                  "plain": plain(first["step"], "plain")}
        if step32 is not None:
            with fp32_compute(cast_model or model):
                routes["kernels_fp32"] = one_step(step32, "kernels_fp32")
                routes["plain_fp32"] = plain(step32, "plain_fp32")
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    if encode_bank is not None:
        routes["banks"] = banks
    return routes


def phase4(_build, mods, dev, seed: int, card: str, readings: dict) -> dict:
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_clip_eval_step, make_label_fn

    t0 = time.perf_counter()
    preset, cfg, model = train_model(dev, seed, "pretrain_clip")
    groups = [g.name for g in preset.train.groups]
    lrs = base_lrs(preset)
    label_fn = make_label_fn(groups)
    batch = train_batch(np.random.default_rng(seed + 2), tokenizer(), dev, TRAIN_BATCH,
                        TRAIN_LEN)
    lengths = batch["attention_mask"].sum(1)
    print(f"model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M fp32 master "
          f"parameters, bf16 compute, dropout {cfg.dropout}; built in "
          f"{time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x 512x512 grey uint8, "
          f"reports of {int(lengths.min())}-{int(lengths.max())} tokens "
          f"({int((lengths == TRAIN_LEN).sum())} full)")
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def fresh(dropout: float):
        """The initial weights, a new optimizer and step, the given dropout."""
        model.load_state_dict(init)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = dropout
        opt, step = pretrain_step(model, preset, cfg)
        return TrainState(model, opt), step

    # -- kernels vs plain versions from the same weights, dropout 0 ------------
    # B2's output is shared: phase 2 holds it to its plain version, and at
    # random init the image tower turns a one-bf16-step change of its input
    # into another gradient direction; cuDNN runs deterministically here, so
    # only the kernels B3, B4, B6 and B8 differ between the two runs
    images = mods["image_prep"].preprocess_images(
        batch["images"], cfg.image_size, cfg.image_size, preset.augment.mean,
        preset.augment.std)
    g = torch.Generator(dev).manual_seed(seed + 3)
    cot = [torch.randn(TRAIN_BATCH, cfg.shared_embedding_dim, device=dev, generator=g)
           for _ in range(2)]

    def fixed_cotangent():
        """Features and the gradient of <features, cot> through both towers."""
        fresh(0.0)
        feats = [f.float() for f in model.train()(images, batch["input_ids"],
                                                   batch["attention_mask"])]
        sum((f * c).sum() for f, c in zip(feats, cot)).backward()
        return [f.detach() for f in feats], group_grads(model, label_fn)

    def one_step():
        state, step = fresh(0.0)
        loss = float(step(state, batch, lrs)[1]["loss"])
        return loss, group_grads(model, label_fn)

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        feats_k, cot_k = fixed_cotangent()
        loss_k, step_k = one_step()
        with plain_kernels(mods, keep=("image_prep",)):
            before = dict(_build.LAUNCHES)
            feats_p, cot_p = fixed_cotangent()
            loss_p, step_p = one_step()
            check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL),
                  "a kernel other than B2 ran during the plain run")
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    for name, a_, b_ in zip(("image", "text"), feats_k, feats_p):
        cos = torch.nn.functional.cosine_similarity(a_, b_, dim=-1)
        print(f"  {name} features, kernels vs plain: row cosine min {float(cos.min()):.6f}, "
              f"norm {float(b_.norm(dim=-1).mean()):.2f}")
    logits_k = feats_k[1] @ feats_k[0].T / cfg.temperature
    logits_p = feats_p[1] @ feats_p[0].T / cfg.temperature
    print(f"  loss logits: max |difference| {float((logits_k - logits_p).abs().max()):.3f} "
          f"at max |logit| {float(logits_p.abs().max()):.1f}")
    print("backward of one fixed cotangent on both towers' features, dropout 0:")
    compare_groups("fixed cotangent", cot_k, cot_p, groups, TOL["grad_cos"])
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"one step, dropout 0: loss {loss_k:.6f} with the kernels, {loss_p:.6f} with the "
          f"plain versions (rel {loss_err:.2e}, tol {TOL['train_loss_rel']:.0e})")
    check(loss_err <= TOL["train_loss_rel"], "train loss differs from the plain step's")
    compare_groups("one step", step_k, step_p, groups, TOL["grad_cos"])
    del cot_k, cot_p, step_k, step_p

    # -- the main path, counted ------------------------------------------------
    state, step = fresh(cfg.dropout)
    eval_step = make_clip_eval_step(
        model, temperature=cfg.temperature, image_size=cfg.image_size,
        mean=preset.augment.mean, std=preset.augment.std, compute_dtype=torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(seed)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss = float(step(state, batch, lrs, gen)[1]["loss"])  # syncs the step
        times.append(time.perf_counter() - t)
        losses.append(loss)
        print(f"  step {i}: loss {loss:.6f}  {times[-1] * 1e3:.1f} ms  "
              f"{TRAIN_BATCH / times[-1]:.1f} samples/s")
    eval_loss = float(eval_step(state, batch)["loss"])
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    steady = times[1:]
    print(f"train path on {card}: {TRAIN_BATCH * len(steady) / sum(steady):.1f} samples/s "
          f"over steps 1-{TRAIN_STEPS - 1} ({1e3 * sum(steady) / len(steady):.1f} ms/step; "
          f"step 0 {times[0] * 1e3:.1f} ms); eval loss {eval_loss:.6f}")
    print(f"launches on the train path: {launches}")
    print(f"peak device memory on the train path: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    readings["train"] = (TRAIN_BATCH * len(steady) / sum(steady),
                         torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    check(all(np.isfinite(losses)) and np.isfinite(eval_loss), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(state.step == TRAIN_STEPS, f"step counter {state.step}")
    after = model.state_dict()
    moved = {}
    for name, _ in model.named_parameters():
        label = label_fn(tuple(name.split(".")))
        moved[label] = moved.get(label, False) or not torch.equal(after[name], init[name])
    print(f"parameter groups moved: {moved}")
    check(all(moved.values()), "a parameter group did not move")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    n_moved = sum(not torch.equal(after[k], init[k]) for k in stats)
    print(f"BatchNorm running statistics moved: {n_moved} of {len(stats)}")
    check(n_moved == len(stats), "BatchNorm running statistics did not all move")
    check_launched(mods, launches, "train")
    return launches


def step_against_plain(_build, mods, first: dict, groups) -> None:
    """Phase 4's check on the first step a command took (first_step_routes):
    the loss within train_loss_rel and each parameter group's gradient
    cosine at least grad_cos."""
    from clip_for_dl_tpu_torch.train import make_label_fn

    routes = first_step_routes(_build, mods, first, make_label_fn(groups))
    (loss_k, grads_k), (loss_p, grads_p) = routes["kernels"], routes["plain"]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  the command's first step, dropout 0: loss {loss_k:.6f} with the kernels, "
          f"{loss_p:.6f} with the plain versions (rel {loss_err:.2e}, tol "
          f"{TOL['train_loss_rel']:.0e})")
    check(loss_err <= TOL["train_loss_rel"], "the command's step loss differs from the plain "
                                             "step's")
    compare_groups("the command's first step", grads_k, grads_p, groups, TOL["grad_cos"])


def a3b_first_step(_build, mods, first: dict, groups, step32) -> None:
    """Phase 10's check on the first step of a pretrain run with a learnable
    temperature (first_step_routes, the fp32 route from ``step32``): the
    loss within a3b_loss_rel and each parameter group's gradient cosine
    with the plain route's at least a3b_grad_cos, or within their own
    bounds (a3b_own) where the fp32 route bears those out; each calibration
    scalar's gradient within calibration_grad_atol + calibration_grad_rel
    of the plain one's (info_nce's bias: zero in both). Then one step of the
    command from logit_scale = log 200 leaves it at log 100."""
    import math

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    name = first["loss_name"]
    own = {what: bound for (loss, what), bound in TOL["a3b_own"].items() if loss == name}
    routes = first_step_routes(_build, mods, first, make_label_fn(groups), step32)
    (loss_k, grads_k), (loss_p, grads_p) = routes["kernels"], routes["plain"]
    (loss_k32, grads_k32), (loss_p32, grads_p32) = routes["kernels_fp32"], routes["plain_fp32"]

    def borne_out(what, departure, rounding, fp32_ok):
        print(f"  {what}: its own bound, on the fp32 route: the kernels' departure from the "
              f"plain route {departure:.3e}, the plain route's from fp32 {rounding:.3e}; the "
              f"fp32 kernels within their tolerance: {fp32_ok}")
        check(fp32_ok and departure <= rounding, f"{name} {what}: the fp32 route does not bear "
                                                 "out its own bound")

    rel, rel32 = abs(loss_k - loss_p) / abs(loss_p), abs(loss_k32 - loss_p32) / abs(loss_p32)
    bound = own.get("loss", TOL["a3b_loss_rel"])
    print(f"  the command's first step, dropout 0: loss {loss_k:.6f} with the kernels, "
          f"{loss_p:.6f} with the plain versions (rel {rel:.2e}, tol {bound:.0e}); the fp32 "
          f"route {loss_k32:.6f} / {loss_p32:.6f} (rel {rel32:.2e})")
    check(rel <= bound, "the command's step loss differs from the plain step's")
    if "loss" in own:
        borne_out("the loss", rel, abs(loss_p - loss_p32) / abs(loss_p32),
                  rel32 <= TOL["fp32_loss_rel"])
    calibration = {k: (grads_k.pop(k), grads_p.pop(k), grads_p32.pop(k)) for k in CALIBRATION}
    compare_groups("the command's first step", grads_k, grads_p, groups,
                   {g: own.get(g, TOL["a3b_grad_cos"]) for g in groups})
    for g in groups:
        cos, cos32 = cosine(grads_k[g], grads_p[g]), cosine(grads_k32[g], grads_p32[g])
        rounding = 1 - cosine(grads_p[g], grads_p32[g])
        print(f"  {g}: 1 - cosine with the plain fp32 gradient {rounding:.3e} on the plain "
              f"route; the fp32 kernels' cosine with it {cos32:.7f}")
        if g in own:
            borne_out(g, 1 - cos, rounding, cos32 >= TOL["fp32_grad_cos"])
    for scalar, (gk, gp, gp32) in calibration.items():
        gk, gp, gp32 = float(gk), float(gp), float(gp32)
        tol = TOL["calibration_grad_atol"] + TOL["calibration_grad_rel"] * abs(gp)
        print(f"  {scalar}: gradient {gk:.6e} with the kernels, {gp:.6e} on the plain route "
              f"(|difference| {abs(gk - gp):.2e}, tol {tol:.2e}), {gp32:.6e} on the plain fp32 "
              f"route")
        check(abs(gk - gp) <= tol and (gp != 0 or gk == 0),
              f"{scalar}: gradient differs from the plain route's")
    model, opt = first["state"].model, first["state"].optimizer
    model.load_state_dict(first["weights"])
    opt.load_state_dict(first["optimizer"])
    with torch.no_grad():
        model.logit_scale.fill_(math.log(200.0))
    first["step"](TrainState(model, opt), first["batch"], *first["rest"])
    after, cap = float(model.logit_scale.detach()), float(np.float32(math.log(100.0)))
    print(f"  one step from logit_scale = log 200: {after:.6f} after it (cap {cap:.6f})")
    check(after == cap, f"the step left logit_scale at {after}, not at log 100")


def lora_first_step(_build, mods, first: dict, groups, frozen, step32) -> None:
    """Phase 12's check on the first step of a LoRA run (first_step_routes
    on the factors, the fp32 route from ``step32`` with the frozen model's
    casts flipped): the loss within train_loss_rel, and each group's factor
    gradient cosine with the plain route's at least grad_cos, or, where it
    is not, the fp32 route bearing the departure out: the fp32 kernels
    within fp32_grad_cos of the plain fp32 route, and the kernels' bf16
    gradient no further from the plain fp32 one (1 - cosine) than
    lora_bf16_ratio times the plain bf16 route's. Prints every reading
    before it fails."""
    from clip_for_dl_tpu_torch.train import make_label_fn

    routes = first_step_routes(_build, mods, first, make_label_fn(groups), step32,
                               cast_model=frozen)
    (loss_k, grads_k), (loss_p, grads_p) = routes["kernels"], routes["plain"]
    (loss_k32, grads_k32), (loss_p32, grads_p32) = routes["kernels_fp32"], routes["plain_fp32"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  the command's first step, dropout 0: loss {loss_k:.6f} with the kernels, "
          f"{loss_p:.6f} with the plain versions (rel {rel:.2e}, tol "
          f"{TOL['train_loss_rel']:.0e}); the fp32 route {loss_k32:.6f} / {loss_p32:.6f}, the "
          f"plain bf16 route's loss {abs(loss_p - loss_p32) / abs(loss_p32):.2e} from fp32")
    failures = []
    for label in sorted(grads_p):
        gk, gp = grads_k[label], grads_p[label]
        if label not in groups:  # the factors the forward does not reach
            print(f"  {label}: zero gradients in both ({gk.numel()} factor entries)")
            if gk.any() or gp.any():
                failures.append(f"{label} gradients not zero")
            continue
        cos, cos32 = cosine(gk, gp), cosine(grads_k32[label], grads_p32[label])
        rounding = 1 - cosine(gp, grads_p32[label])
        kernels_off = 1 - cosine(gk, grads_p32[label])
        ok = cos >= TOL["grad_cos"] or (
            kernels_off <= TOL["lora_bf16_ratio"] * rounding
            and cos32 >= TOL["fp32_grad_cos"])
        print(f"  {label}: gradient cosine {cos:.6f} (tol {TOL['grad_cos']}), norms "
              f"{float(gk.norm()):.4e} / {float(gp.norm()):.4e}; from the plain fp32 gradient "
              f"(1 - cosine): the kernels {kernels_off:.3e}, the plain bf16 route "
              f"{rounding:.3e}; the fp32 kernels' cosine {cos32:.7f}"
              + ("" if cos >= TOL["grad_cos"] else
                 f"; below the bound, borne out by the fp32 route: {ok}"))
        if not ok:
            failures.append(f"{label} gradient differs from the plain version's")
    if rel > TOL["train_loss_rel"]:
        failures.append("the loss differs from the plain step's")
    check(not failures, f"the LoRA run's first step: {failures}")


def step_split(dev, first: dict, points: dict, gaps: dict, n: int = 5) -> tuple:
    """Test-only instrumentation: the command's own step and state, n times
    after one warm-up, each from the weights, optimizer state and generator
    state its first step started from, on that batch, synchronized at the
    bounds of its parts. Returns the median ms of each part in ``points``
    (part -> (owner, attribute): that call, patched), of each in ``gaps``
    (part -> (part a, part b): from the end of a to the start of b), of the
    rest (what lies between them) and of the whole step so instrumented;
    and the last output of each call in ``points``."""
    import torch

    model, opt = first["state"].model, first["state"].optimizer
    marks, last = {}, {}

    def mark(label):
        torch.cuda.synchronize(dev)
        marks[label] = time.perf_counter()

    def around(fn, label):
        def timed(*a, **kw):
            mark(label + "<")
            last[label] = fn(*a, **kw)
            mark(label + ">")
            return last[label]
        return timed

    parts = {k: [] for k in (*points, *gaps, "rest", "step")}
    with ExitStack() as stack:
        for label, (owner, attribute) in points.items():
            stack.enter_context(mock.patch.object(
                owner, attribute, around(getattr(owner, attribute), label)))
        for i in range(n + 1):
            model.load_state_dict(first["weights"])
            opt.load_state_dict(first["optimizer"])
            if first.get("generator") is not None:
                first["rest"][-1].set_state(first["generator"])
            marks.clear()
            mark("step<")
            first["step"](first["state"], first["batch"], *first["rest"])
            mark("step>")
            if i == 0:
                continue
            t = {k: (marks[k + ">"] - marks[k + "<"]) * 1e3 if k + "<" in marks else 0.0
                 for k in (*points, "step")}
            t.update({k: (marks[b + "<"] - marks[a + ">"]) * 1e3 for k, (a, b) in gaps.items()})
            t["rest"] = t["step"] - sum(v for k, v in t.items() if k != "step")
            for k, v in t.items():
                parts[k].append(v)
    return {k: statistics.median(v) for k, v in parts.items()}, last


def loss_alone(dev, first: dict, steps_module, feats) -> float:
    """Test-only: ms of the pretrain loss alone, forward and backward, on the
    step's features (image, text), CUDA events over 20 calls."""
    import torch

    model = first["state"].model
    contrastive = steps_module._contrastive(first["loss_name"], first["temperature"])
    params = dict(model.named_parameters(recurse=False))
    img, txt = (f.detach().clone().requires_grad_() for f in feats)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    contrastive(txt, img, params).backward()
    start.record()
    for _ in range(20):
        contrastive(txt, img, params).backward()
    end.record()
    torch.cuda.synchronize(dev)
    model.zero_grad(set_to_none=True)
    return start.elapsed_time(end) / 20


def first_step_readings(_build, mods, dev, case: str, cfg, seeds, weight_decay, label_fn,
                        groups, make, encode_bank=None) -> list:
    """The readings of a sweep: for each seed, a model of ``cfg`` at full
    width from that seed's weights, bf16 compute, AdamW under ``label_fn``;
    ``make(model, opt, seed) -> (step, step32, batch, rest)`` builds the
    step, its fp32 twin, the batch and the step's arguments before the
    generator (seeded with the seed); the first step on the four routes of
    first_step_routes at dropout 0, with ``encode_bank`` when given. One
    JSON row a seed, printed and returned: the losses and, for each of
    ``groups``, the cosine of the kernels' gradient with the plain one's, of
    each with the plain fp32 one's, of the fp32 kernels' with it, and the
    plain norm; each calibration scalar's gradient on each route, where the
    model has them; and, returned only, the banks when encoded."""
    import torch

    from clip_for_dl_tpu_torch.core.device import cast_in_forward
    from clip_for_dl_tpu_torch.models import CXRClip, init_weights
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn, make_optimizer

    rows = []
    for seed in seeds:
        with torch.device(dev):
            model = CXRClip(cfg)
        init_weights(model, torch.Generator(dev).manual_seed(seed))
        cast_in_forward(model, torch.bfloat16)
        opt = make_optimizer(model, label_fn, weight_decay=weight_decay)
        step, step32, batch, rest = make(model, opt, seed)
        gen = torch.Generator(dev).manual_seed(seed)
        first = dict(state=TrainState(model, opt), step=step, batch=batch, rest=(*rest, gen),
                     generator=gen.get_state(),
                     weights={k: v.detach().clone() for k, v in model.state_dict().items()},
                     optimizer=copy.deepcopy(opt.state_dict()))
        r = first_step_routes(_build, mods, first, make_label_fn(groups), step32, encode_bank)
        banks = r.pop("banks", None)
        k, p, k32, p32 = (r[x][1] for x in ("kernels", "plain", "kernels_fp32", "plain_fp32"))
        row = {"case": case, "seed": seed, "losses": {x: r[x][0] for x in r},
               "groups": {g: {"kernels_plain": cosine(k[g], p[g]),
                              "kernels_plain_fp32": cosine(k[g], p32[g]),
                              "plain_plain_fp32": cosine(p[g], p32[g]),
                              "fp32_kernels_plain_fp32": cosine(k32[g], p32[g]),
                              "norm": float(p[g].norm())} for g in groups}}
        if all(c in k for c in CALIBRATION):
            row["calibration"] = {c: {x: float(r[x][1][c]) for x in r} for c in CALIBRATION}
        print(json.dumps(row))
        rows.append(dict(row, banks=banks))
        del model, opt, first, step, step32, r, k, p, k32, p32
        torch.cuda.empty_cache()
    return rows


def print_extremes(case: str, rows: list, groups) -> None:
    """A sweep's extremes over its seeds: the loss's relative departure of
    the kernels from the plain route, the plain route's from fp32, their
    ratio and the fp32 kernels' departure; for each group the cosines'
    minima, the ratio of 1 − cosine (kernels vs plain) to 1 − cosine (plain
    vs plain fp32), and the norms."""
    losses = [r["losses"] for r in rows]
    rel = [abs(x["kernels"] - x["plain"]) / abs(x["plain"]) for x in losses]
    rounding = [abs(x["plain"] - x["plain_fp32"]) / abs(x["plain_fp32"]) for x in losses]
    rel32 = [abs(x["kernels_fp32"] - x["plain_fp32"]) / abs(x["plain_fp32"]) for x in losses]
    print(f"{case}, seeds {[r['seed'] for r in rows]}: loss rel, kernels vs plain, max "
          f"{max(rel):.3e}; the plain route's rel from fp32 min {min(rounding):.3e}; their ratio "
          f"max {max(a / b for a, b in zip(rel, rounding)):.3f}; fp32 kernels vs plain max "
          f"{max(rel32):.2e}")
    for g in groups:
        c = {key: [r["groups"][g][key] for r in rows] for key in rows[0]["groups"][g]}
        ratio = [(1 - a) / (1 - b) for a, b in zip(c["kernels_plain"], c["plain_plain_fp32"])]
        print(f"  {g}: cosine kernels vs plain min {min(c['kernels_plain']):.6f}; with the "
              f"plain fp32 gradient min {min(c['kernels_plain_fp32']):.6f} (kernels), "
              f"{min(c['plain_plain_fp32']):.6f} (plain); 1 - cosine of kernels vs plain over "
              f"the plain route's from fp32, max {max(ratio):.4f}; fp32 kernels min "
              f"{min(c['fp32_kernels_plain_fp32']):.7f}; norms "
              f"{min(c['norm']):.3e}-{max(c['norm']):.3e}")


def first_step_sweep(_build, mods, dev, seeds) -> None:
    """The readings behind phase 10's own bounds (a3b_own, and the
    calibration scalars' tolerance): the first step of pretrain_clip at full
    width with a learnable temperature, siglip (s = 10, b = -10) and
    info_nce (s = 1/T), B = 16, from the weights and a train_batch of each
    seed (first_step_readings). Then the extremes over the seeds. Checks
    nothing."""
    import dataclasses

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import get_preset
    from clip_for_dl_tpu_torch.tools.main_paths import base_lrs, tokenizer, train_batch
    from clip_for_dl_tpu_torch.train import make_clip_pretrain_step, make_label_fn

    preset = get_preset("pretrain_clip")
    groups = [g.name for g in preset.train.groups]
    label_fn = make_label_fn(groups)
    tok = tokenizer()
    for loss_name in ("siglip", "info_nce"):
        cfg = dataclasses.replace(
            preset.model, flash_attention=True, bert_fused_mlp=True, learnable_temperature=True,
            logit_scale_init=10.0 if loss_name == "siglip" else None)
        kw = dict(loss_name=loss_name, temperature=cfg.temperature, image_size=cfg.image_size,
                  mean=preset.augment.mean, std=preset.augment.std,
                  max_grad_norm=preset.train.max_grad_norm)

        def make(model, opt, seed):
            return (make_clip_pretrain_step(model, opt, label_fn, **kw),
                    make_clip_pretrain_step(model, opt, label_fn, compute_dtype=torch.float32,
                                            **kw),
                    train_batch(np.random.default_rng(seed), tok, dev, preset.data.batch_size,
                                cfg.max_text_length),
                    (base_lrs(preset),))

        rows = first_step_readings(_build, mods, dev, loss_name, cfg, seeds,
                                   preset.train.weight_decay, label_fn, groups, make)
        print_extremes(loss_name, rows, groups)
        for name in CALIBRATION:
            d = [abs(r["calibration"][name]["kernels"] - r["calibration"][name]["plain"])
                 for r in rows]
            print(f"  {name}: gradient |kernels - plain| max {max(d):.3e}, min {min(d):.3e}")


def states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch_equal(a[k], b[k]) for k in a)


def torch_equal(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and states_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(torch_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase6(_build, mods, dev, seed: int, card: str, tmp: str) -> dict:
    """The chain pretrain -> adapter through fit and CheckpointManager, the
    checkpoints under ``tmp`` (``pretrain/``, ``adapter/``; phase 8 reads
    them); returns the launches of the pretrain_fit and adapter paths."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.evals import multilabel_metrics
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import (
        CheckpointManager, PreemptionGuard, TrainState, fit, make_adapter_eval_step,
        make_adapter_train_step, make_clip_eval_step, make_label_fn, make_optimizer,
        resume_or_init, run_eval,
    )
    from clip_for_dl_tpu_torch.train.checkpoint import model_state

    rng = np.random.default_rng(seed + 7)
    tok = tokenizer()
    batches = [train_batch(rng, tok, dev, TRAIN_BATCH, TRAIN_LEN) for _ in range(2)]
    by_path = {}
    save_ms = []

    def timed_saves(mgr):
        for name in ("save", "save_preempt"):
            original = getattr(mgr, name)

            def timed(*a, _original=original, **kw):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                _original(*a, **kw)
                save_ms.append((time.perf_counter() - t) * 1e3)

            setattr(mgr, name, timed)
        return mgr

    # -- phase A: pretrain through fit, one epoch ---------------------------
    preset, cfg, model = train_model(dev, seed, "pretrain_clip")
    opt, step = pretrain_step(model, preset, cfg)
    eval_step = make_clip_eval_step(
        model, temperature=cfg.temperature, image_size=cfg.image_size,
        mean=preset.augment.mean, std=preset.augment.std, compute_dtype=torch.bfloat16)
    ckpt_a = timed_saves(CheckpointManager(f"{tmp}/pretrain", max_to_keep=1))
    lrs = base_lrs(preset)
    print(f"phase A: pretrain_clip, fit for 1 epoch of {CHAIN_STEPS} steps at "
          f"B = {TRAIN_BATCH}, scheduler {preset.train.scheduler}")
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t = time.perf_counter()
    state_a, hist_a = fit(
        TrainState(model, opt), step, eval_step,
        lambda: (batches[i % 2] for i in range(CHAIN_STEPS)), lambda: iter(batches[1:]),
        base_lrs=lrs, num_epochs=1,
        rng_stream=itertools.repeat(torch.Generator(dev).manual_seed(seed)),
        scheduler=preset.train.scheduler, early_stop_patience=None, checkpointer=ckpt_a,
        log_every=1)
    torch.cuda.synchronize(dev)
    by_path["pretrain_fit"] = dict(_build.LAUNCHES)
    print(f"  history {hist_a.rows} in {time.perf_counter() - t:.1f} s; checkpoint save "
          f"{[round(x, 1) for x in save_ms]} ms; launches {by_path['pretrain_fit']}")
    check(len(hist_a.rows) == 1 and all(np.isfinite([hist_a.rows[0]["train_loss"],
                                                     hist_a.rows[0]["val_loss"]])),
          f"phase A history {hist_a.rows}")
    check(ckpt_a.all_epochs() == [0] and state_a.step == CHAIN_STEPS,
          f"phase A checkpoints {ckpt_a.all_epochs()}, step {state_a.step}")
    check_launched(mods, by_path["pretrain_fit"], "pretrain_fit")
    pretrained = {k: v.clone() for k, v in model_state(model).items()}
    del model, opt, step, eval_step, state_a
    torch.cuda.empty_cache()

    # -- phase B: the adapter from the phase-A epoch --------------------------
    preset_b, cfg_b, model_b = train_model(dev, seed + 1, "adapter")
    check(ckpt_a.restore_variables(model_b) is model_b, "no phase-A checkpoint to restore")
    check(states_equal(model_state(model_b), pretrained),
          "restore_variables did not give the phase-A weights")
    del pretrained
    label_b = make_label_fn([g.name for g in preset_b.train.groups])
    opt_b = make_optimizer(model_b, label_b, weight_decay=preset_b.train.weight_decay)
    prep_b = dict(image_size=cfg_b.image_size, mean=preset_b.augment.mean,
                  std=preset_b.augment.std, compute_dtype=torch.bfloat16)
    step_b = make_adapter_train_step(model_b, opt_b, label_b, **prep_b)
    eval_b = make_adapter_eval_step(model_b, **prep_b)
    labels = rng.random((TRAIN_BATCH, cfg_b.num_classes)) < 0.3
    labels[0], labels[1] = True, False  # every class has both outcomes
    batch = {"images": batches[0]["images"],
             "labels": torch.from_numpy(labels.astype(np.float32)).to(dev)}
    before = model_state(model_b)
    frozen = {k: v.clone() for k, v in before.items() if not k.startswith("adapter.")}
    adapter0 = {k: v.clone() for k, v in before.items() if k.startswith("adapter.")}
    guard = PreemptionGuard(signals=())
    preempt_after = 2 * CHAIN_STEPS + 2
    times, losses = [], []

    def timed_step(state, b, lrs_, gen):
        t0 = time.perf_counter()
        state, metrics = step_b(state, b, lrs_, gen)
        losses.append(float(metrics["loss"]))  # syncs the step
        times.append(time.perf_counter() - t0)
        if len(times) == preempt_after:
            guard.trigger()
        return state, metrics

    ckpt_b = timed_saves(CheckpointManager(f"{tmp}/adapter", max_to_keep=1))
    base_b = {"adapter": preset_b.train.lr, "default": 0.0}
    print(f"phase B: adapter, fit for 2 epochs of {CHAIN_STEPS} steps at B = "
          f"{TRAIN_BATCH}, best-1 retention, preemption after step 2 of epoch 2")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    save_ms.clear()
    _build.reset_launches()
    state_b, hist_b = fit(
        TrainState(model_b, opt_b), timed_step, eval_b,
        lambda: itertools.repeat(batch, CHAIN_STEPS), lambda: iter([batch]),
        base_lrs=base_b, num_epochs=3, rng_stream=itertools.repeat(None),
        scheduler=preset_b.train.scheduler,
        early_stop_patience=preset_b.train.early_stop_patience, checkpointer=ckpt_b,
        preemption_guard=guard, log_every=1)
    torch.cuda.synchronize(dev)
    by_path["adapter"] = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steady = times[1:]
    print(f"  history {hist_b.rows}")
    print(f"  step losses {[round(x, 6) for x in losses]}")
    print(f"adapter path on {card}: {TRAIN_BATCH * len(steady) / sum(steady):.1f} "
          f"samples/s over steps 1-{len(times) - 1} (each synced; step 0 "
          f"{times[0] * 1e3:.1f} ms); checkpoint saves {[round(x, 1) for x in save_ms]} ms; "
          f"peak device memory {peak:.2f} GiB; launches {by_path['adapter']}")

    after = model_state(model_b)
    check(all(torch.equal(after[k], v) for k, v in frozen.items()),
          "a tower parameter or BatchNorm statistic changed in phase B")
    check(all(not torch.equal(after[k], v) for k, v in adapter0.items()),
          "the adapter did not move")
    check(len(losses) == preempt_after and all(np.isfinite(losses)),
          f"phase B step losses {losses}")
    val = [r["val_loss"] for r in hist_b.rows]
    # Adam at the preset's lr 1e-3 overshoots on the fixed batch within
    # an epoch, so the check is against the first step's loss
    check(len(val) == 2 and losses[-1] < losses[0] and min(val) < losses[0],
          f"phase B losses did not fall on the fixed batch: {losses}, val {val}")
    best = 1 if val[1] <= val[0] else 0  # ties rank the newest best
    check(ckpt_b.all_epochs() == [best] and ckpt_b.best_epoch() == best,
          f"retained {ckpt_b.all_epochs()}, best {ckpt_b.best_epoch()}; val {val}")
    check(ckpt_b.preempt_latest() == 2, f"preemption slot {ckpt_b.preempt_latest()}")
    _, _, fresh = train_model(dev, seed + 2, "adapter")
    fresh_opt = make_optimizer(fresh, label_b, weight_decay=preset_b.train.weight_decay)
    resumed, start = resume_or_init(ckpt_b, TrainState(fresh, fresh_opt))
    # JAX's rule: a mid-epoch save newer than every kept epoch, no loader
    # to replay into -> the next epoch
    check(start == 3, f"resume_or_init started at epoch {start}, not 3")
    check(resumed.step == state_b.step == preempt_after, f"step {resumed.step}")
    check(states_equal(model_state(fresh), after), "resumed weights differ")
    check(torch_equal(fresh_opt.state_dict(), opt_b.state_dict()),
          "resumed optimizer state differs")
    print(f"  retained epoch {ckpt_b.all_epochs()} (val {val}); preemption slot at "
          f"epoch {ckpt_b.preempt_latest()}; resume_or_init -> epoch {start}, "
          "state bit-equal")
    del fresh, fresh_opt, resumed
    ev = run_eval(eval_b, state_b, [batch])
    metrics = multilabel_metrics(ev["probs"], ev["labels"], class_names=DISEASE_LABELS)
    check(ev["probs"].shape == (TRAIN_BATCH, cfg_b.num_classes)
          and np.isfinite(metrics["auroc_macro"]), f"run_eval metrics {metrics}")
    print(f"  run_eval: loss {ev['loss']:.6f}, macro AUROC {metrics['auroc_macro']:.4f}, "
          f"mAP {metrics['mAP']:.4f}")
    check_launched(mods, by_path["adapter"], "adapter")
    return by_path

def host_probe() -> str:
    """What the machine offers the host side of the port, as one line: g++
    (which builds the port's image decoder, native/src/*.cpp, at
    first use), libpng's, zlib's and libjpeg's headers, -lpng16 / -lpng /
    -lz / -ljpeg at link time, and whether the packages the port may not
    import (the CPU tests' oracles, phase 20's cv2 yardstick) are installed,
    found without importing them. The port's PNG decoder
    (native/bindings.py) is written for a machine without libpng."""
    import importlib.util
    import shutil

    gxx = shutil.which("g++")
    parts = [f"g++ {gxx or 'missing'}"]

    def builds(src: str, *args) -> bool:
        with tempfile.TemporaryDirectory(prefix="probe_") as tmp:
            path = Path(tmp) / "probe.cpp"
            path.write_text(src)
            return gxx is not None and subprocess.run(
                [gxx, str(path), "-o", str(Path(tmp) / "probe"), *args],
                capture_output=True, timeout=120).returncode == 0

    for header in ("png.h", "zlib.h", "jpeglib.h"):
        found = builds(f"#include <stdio.h>\n#include <{header}>\nint main() {{ return 0; }}\n",
                       "-c")
        parts.append(f"{header} {'found' if found else 'missing'}")
    for lib in ("-lpng16", "-lpng", "-lz", "-ljpeg"):
        parts.append(f"{lib} {'links' if builds('int main() { return 0; }', lib) else 'missing'}")
    for mod in ("safetensors", "PIL", "sklearn", "pandas", "cv2", "matplotlib"):
        parts.append(f"{mod} {'installed' if importlib.util.find_spec(mod) else 'missing'}")
    return "; ".join(parts)


def apart(x) -> float:
    """How far the outputs of two inputs lie apart: the median, over the rows
    of ``x`` (one an input), of the largest difference between a row and the
    next of a fixed shuffle. A fault that put one input's output in
    another's place would show an error about this large."""
    import numpy as np
    import torch

    x = np.asarray(x.float().cpu() if torch.is_tensor(x) else x, np.float64)
    x = x[np.random.default_rng(0).permutation(len(x))]
    return float(np.median(np.abs(x - np.roll(x, 1, axis=0)).reshape(len(x), -1).max(1)))


def held(what: str, got, want, tol: float, spreads: dict, failures: list, results=None,
         name=None, bound: bool = True) -> None:
    """Print a comparison's largest error beside its tolerance and the
    spreads of its outputs between inputs; add to ``failures`` unless the
    error is within the tolerance and, with ``bound``, the tolerance below
    every spread (a comparison that could not see a wrong input proves
    nothing). With ``name``, the error also counts toward that kernel's
    max_abs_err."""
    import numpy as np
    import torch

    got, want = (np.asarray(t.float().cpu() if torch.is_tensor(t) else t, np.float64)
                 for t in (got, want))
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
    err = float(np.abs(got - want).max()) if np.isfinite(got).all() else float("inf")
    print(f"  {what}: max_abs {err:.3e}  tol {tol:.1e}; apart over "
          + ", ".join(f"{k} {v:.3e}" for k, v in spreads.items()))
    if not err <= tol:
        failures.append(f"{what}: max_abs {err} > tol {tol}")
    failures.extend(f"{what}: tol {tol} is not below the spread over {k} ({v})"
                    for k, v in spreads.items() if bound and not tol < v)
    if name:
        results.setdefault(name, {})["max_abs_err"] = max(
            err, results.get(name, {}).get("max_abs_err", 0.0))


def eval_files_phase(_build, mods, dev, seed: int, card: str, workdir: str,
                     results: dict) -> dict:
    """Phase 8: the evaluation half of the JAX CLI's ``zeroshot`` as library
    calls, from PNG and CSV files to metrics, over phase 6's checkpoints in
    ``workdir``; returns the launches of the eval_files and eval_adapter
    paths."""
    import dataclasses

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.core.device import cast_matmul_weights
    from clip_for_dl_tpu_torch.data import (
        ChestXrayMultiViewDataset, HostLoader, build_exam_index, build_image_cache,
        merge_image_report, prepare_labeled_csv, read_csv, split_by_uid,
    )
    from clip_for_dl_tpu_torch.data.frame import key
    from clip_for_dl_tpu_torch.inference import AdapterEngine, InferenceSession, load_trained_model
    from clip_for_dl_tpu_torch.models.safetensors_io import save_reference_checkpoint_safetensors
    from clip_for_dl_tpu_torch.testing.kaggle import write_kaggle_layout
    from clip_for_dl_tpu_torch.tools.main_paths import tokenizer
    from clip_for_dl_tpu_torch.train import CheckpointManager
    from clip_for_dl_tpu_torch.train.checkpoint import model_state, reference_models
    from clip_for_dl_tpu_torch.zeroshot import (
        ZeroShotEngine, prompts_for_family, run_dynamic_threshold_eval, run_zero_shot_eval,
    )
    from clip_for_dl_tpu_torch.zeroshot.thresholds import (
        NO_NEGATIVES_THRESHOLD, NO_POSITIVES_THRESHOLD,
    )

    t_phase = time.perf_counter()
    root = f"{workdir}/kaggle"
    t = time.perf_counter()
    paths = write_kaggle_layout(root, EVAL_UIDS, sizes=EVAL_SIZES, empty_findings_every=9,
                                single_view_uids=(5,), not_png_uids=(11,), seed=seed)
    print(f"wrote the Kaggle layout: {EVAL_UIDS} uids, grey 8-bit PNGs at {EVAL_SIZES} with "
          f"random row filters, uid 5 frontal only, uid 11's frontal not a PNG, every 9th "
          f"report's findings empty, in {time.perf_counter() - t:.1f} s")

    # -- the data side: labels, merge, split, exam index ----------------------
    preset = get_preset("zero_shot")
    cfg = preset.replace(model=dataclasses.replace(preset.model, flash_attention=True,
                                                   bert_fused_mlp=True))
    size = cfg.model.image_size
    labeled_csv = f"{root}/indiana_reports_labeled.csv"
    prepare_labeled_csv(paths["reports"], labeled_csv)
    reports, projections = read_csv(labeled_csv), read_csv(paths["projections"])
    merged = merge_image_report(projections, reports)
    train_f, val_f = split_by_uid(merged, cfg.data.test_size, cfg.data.seed)
    uids = {key(u) for u in merged.column("uid")}
    train_u, val_u = ({key(u) for u in f.column("uid")} for f in (train_f, val_f))
    check(not train_u & val_u and train_u | val_u == uids, "split_by_uid lost or shared a uid")
    # the weights are random and nothing was trained on these files, so the
    # smoke scores the exams of both splits (the CLI scores the validation one)
    index = build_exam_index(reports.where(lambda r: key(r["uid"]) in uids), projections,
                             paths["image_dir"])
    n = len(index)
    check(n == len(uids) and 5 in uids and 11 in uids and not any(u % 9 == 0 for u in uids),
          f"exam index of {n} exams for {len(uids)} uids")
    check(index.view_types[list(index.uids).index(5)] == ("frontal", "frontal"),
          "the single-view exam was not duplicated")
    print(f"labels and exam index: {len(reports)} reports, {len(merged)} labeled images with "
          f"findings, split {len(train_u)} / {len(val_u)} uids, {n} exams")

    # -- the image cache and the loader ----------------------------------------
    files = list(dict.fromkeys(p for pair in zip(index.frontal_paths, index.lateral_paths)
                               for p in pair))
    t = time.perf_counter()
    cache = build_image_cache(files, size, f"{root}/cache", workers=8)
    cache_s = time.perf_counter() - t
    bad = index.frontal_paths[list(index.uids).index(11)]
    check(cache.channels == 1 and len(cache) == len(files), f"cache {len(cache)} rows, "
          f"{cache.channels} channels")
    check(not cache.get(bad).any() and all(cache.get(p).any() for p in files if p != bad),
          "the cache's zero rows are not exactly the file that is not a PNG")
    dataset = ChestXrayMultiViewDataset(index, size, cache=cache)
    loader = HostLoader(dataset, EVAL_BATCH, num_threads=8)
    batches = list(loader)
    check(len(batches) == -(-n // EVAL_BATCH)
          and all(b["images"].shape == (EVAL_BATCH, 2, size, size, 1) for b in batches)
          and int(sum(b["mask"].sum() for b in batches)) == n, "loader batches")

    # -- the weights, three ways -------------------------------------------------
    weights = load_trained_model(f"{workdir}/pretrain", cfg, torch.float32, seed=seed,
                                 device=dev)
    state = model_state(weights)
    saved = torch.load(f"{workdir}/pretrain/0.pt", map_location="cpu", weights_only=True)
    check(all(torch.equal(state[k].cpu(), v) for k, v in saved["model"].items()),
          "load_trained_model did not give the phase-A checkpoint's weights")
    pth = f"{workdir}/model_best.pth"
    torch.save({"epoch": 0, "models": reference_models({k: v.cpu() for k, v in state.items()})},
               pth)
    mirror = save_reference_checkpoint_safetensors(state, f"{workdir}/model_best.safetensors")
    del state, saved
    cast_matmul_weights(weights, torch.bfloat16)
    models = {"checkpoint directory": weights,
              ".pth": load_trained_model(pth, cfg, seed=seed, device=dev),
              ".safetensors": load_trained_model(mirror, cfg, seed=seed, device=dev)}
    tok = tokenizer()
    prompts = prompts_for_family("prediction", DISEASE_LABELS)

    def engine_of(model):
        return ZeroShotEngine(model, tok, DISEASE_LABELS, cfg.zeroshot, cfg.augment.mean,
                              cfg.augment.std, size, cfg.model.max_text_length, torch.bfloat16)

    logits = {}
    for name, model in models.items():
        e = engine_of(model)
        e.build_text_features(prompts)
        logits[name] = e.logits(batches[0]["images"])
    check(all(np.array_equal(v, logits[".pth"]) for v in logits.values()),
          "the three weight sources give different logits")
    print(f"weights from the phase-A checkpoint directory, a reference .pth and a .safetensors "
          f"mirror: logits {logits['.pth'].shape} bit-equal")
    del models[".pth"], models[".safetensors"]
    torch.cuda.empty_cache()

    # -- the main path, counted --------------------------------------------------
    engine = engine_of(weights)
    by_path = {}
    zc = cfg.zeroshot
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    engine.build_text_features(prompts)
    t = time.perf_counter()
    zs = run_zero_shot_eval(engine, loader, zc.top_k, f"{workdir}/zero_shot_results.csv")
    eval_s = time.perf_counter() - t
    dyn = run_dynamic_threshold_eval(engine, lambda: iter(loader), zc.threshold_calib_frac,
                                     zc.threshold_grid_points, zc.frontal_weight,
                                     zc.lateral_weight, f"{workdir}/zero_shot_dynamic.csv")
    session = InferenceSession(weights, tok, DISEASE_LABELS, cfg.augment.mean, cfg.augment.std,
                               size, max_text_length=cfg.model.max_text_length)
    s_preds, s_probs = session(batches[0]["images"])
    torch.cuda.synchronize(dev)
    by_path["eval_files"] = dict(_build.LAUNCHES)
    print(f"launches on the eval_files path: {by_path['eval_files']}")
    check_launched(mods, by_path["eval_files"], "eval_files")
    for out in (zs, dyn):
        check(len(out["predictions"]) == n and out["pred_matrix"].shape == (n, 16)
              and np.array_equal(out["labels"], index.labels), "driver outputs")
        check(all(np.isfinite(out["metrics"][k]) for k in ("f1_micro", "exact_match", "mAP")),
              f"metrics {out['metrics']}")
        with open(out["csv_path"], newline="") as f:
            rows = list(csv.reader(f))
        check(rows[0] == ["predictions", "scores", "true_labels"] and len(rows) == n + 1,
              f"{out['csv_path']}: {len(rows)} lines")
    check(s_probs.shape == (EVAL_BATCH, 16) and bool(np.isfinite(s_probs).all()),
          "InferenceSession probabilities")
    keys = sorted(k for k in zs["metrics"] if not k.startswith("auroc/"))
    print(f"metric keys (run_zero_shot_eval): {keys}")
    print(f"metric keys added by run_dynamic_threshold_eval: "
          f"{sorted(set(dyn['metrics']) - set(zs['metrics']))}; per_class of "
          f"{len(dyn['per_class'])} diseases")
    print("run_zero_shot_eval: " + ", ".join(f"{k} {zs['metrics'][k]:.4f}" for k in
                                              ("f1_micro", "exact_match", "mAP")))
    thresholds = [round(v, 4) for v in dyn["thresholds"].values()]
    print(f"run_dynamic_threshold_eval: thresholds {thresholds}")

    # -- the adapter checkpoint on the same loader, counted -----------------------
    preset_b = get_preset("adapter")
    cfg_b = preset_b.replace(model=cfg.model)
    adapter = load_trained_model(f"{workdir}/adapter", cfg_b, seed=seed, device=dev)
    best = CheckpointManager(f"{workdir}/adapter").best_epoch()
    saved = torch.load(f"{workdir}/adapter/{best}.pt", map_location="cpu",
                       weights_only=True)["model"]
    check(torch.equal(adapter.adapter.classifier.weight.cpu(),
                      saved["adapter.classifier.weight"].to(torch.bfloat16)),
          "the adapter checkpoint's classifier did not load")
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    ad = AdapterEngine(adapter, cfg_b.augment.mean, cfg_b.augment.std, size)
    ad_logits = np.concatenate([ad.logits(b["images"]) for b in batches])
    torch.cuda.synchronize(dev)
    by_path["eval_adapter"] = dict(_build.LAUNCHES)
    check(ad_logits.shape == (2 * EVAL_BATCH * len(batches), 16) and bool(
        np.isfinite(ad_logits).all()), "AdapterEngine logits")
    check_launched(mods, by_path["eval_adapter"], "eval_adapter")
    print(f"AdapterEngine over the phase-B checkpoint: logits {ad_logits.shape}; launches "
          f"{by_path['eval_adapter']}")

    # -- host rates over several passes; the decode's threads ----------------------
    t = time.perf_counter()
    for _ in range(EVAL_PASSES):
        loaded = list(loader)
    loader_s = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(EVAL_PASSES):
        run_zero_shot_eval(engine, loader, zc.top_k)
    passes_s = time.perf_counter() - t
    from clip_for_dl_tpu_torch.tools.decode_threads import measure

    threads = measure(files[:DECODE_FILES], size, 8)
    print(f"host decode of {DECODE_FILES} of the PNGs to {size}x{size}, each stage in one "
          f"thread and over 8, median of 3 (tools/decode_threads.py) on {card}: "
          f"{json.dumps(threads)}")

    # -- the kernels at this path's inputs, and the route against the plain one ----
    # A kernel that wrote a wrong pixel or scored a wrong row would move an
    # output by about as much as outputs differ between inputs, so every
    # comparison below prints that spread (see apart) beside its error and
    # tolerance, and holds the tolerance below it where the route allows.
    failures: list = []
    prep, sim = mods["image_prep"], mods["similarity"]
    mean, std = cfg.augment.mean, cfg.augment.std
    real = np.concatenate([np.repeat(b["mask"].astype(bool), 2) for b in batches])

    def cache_batch(b):
        return torch.from_numpy(b["images"].reshape(-1, size, size, 1)).to(dev)

    grey = cache_batch(batches[0])
    x_ref = prep.preprocess_reference(grey, size, size, mean, std)
    x = prep.preprocess_images(grey, size, size, mean, std)
    neighbour = float((x_ref[:, :, 1:].float() - x_ref[:, :, :-1].float()).abs().median())
    held(f"B2 on a cache batch {list(grey.shape)} uint8 -> {list(x.shape)} bf16", x, x_ref,
         TOL["image_prep"], {"a pixel and its neighbour (median)": neighbour}, failures,
         results, "image_prep")
    with torch.inference_mode():
        feats = weights.encode_image(x, normalize=True).float()
        fused = weights.encode_multiview(x.reshape(-1, 2, *x.shape[1:])).float()
    for what, a, b, T in (("the zero-shot engine's", feats, engine.text_features, zc.temperature),
                          ("InferenceSession's", fused, session.text_features,
                           1.0 / session.logit_scale)):
        want = sim.similarity_reference(a, b, T)
        held(f"B1 at {what} inputs {list(a.shape)} x {list(b.shape)}, T = {T}",
             sim.similarity(a, b, T), want, TOL["similarity"],
             {"rows": apart(want), "classes": apart(want.T)}, failures, results, "similarity")

    def image_features():
        """Unit features of every real view (normalized in fp32, so that
        their spread is not a bf16 step's) and fused features of every real
        exam, from the prep the current route gives B2."""
        views, fused = [], []
        with torch.inference_mode():
            for b in batches:
                x = prep.preprocess_images(cache_batch(b), size, size, mean, std)
                f = weights.encode_image(x).float()
                views.append((f / f.norm(dim=-1, keepdim=True)).cpu().numpy())
                fused.append(weights.encode_multiview(x.reshape(-1, 2, *x.shape[1:]))
                             .float().cpu().numpy())
        return np.concatenate(views)[real], np.concatenate(fused)[real[::2]]

    view_feats, fused_feats = image_features()
    view_logits = np.concatenate([engine.logits(b["images"]) for b in batches])[real]
    with plain_kernels(mods):
        before = dict(_build.LAUNCHES)
        plain = engine_of(weights)
        plain.build_text_features(prompts)
        plain_feats, plain_fused = image_features()
        plain_logits = np.concatenate([plain.logits(b["images"]) for b in batches])[real]
        zs_p = run_zero_shot_eval(plain, loader, zc.top_k)
        dyn_p = run_dynamic_threshold_eval(plain, lambda: iter(loader), zc.threshold_calib_frac,
                                           zc.threshold_grid_points, zc.frontal_weight,
                                           zc.lateral_weight)
        plain_session = InferenceSession(
            weights, tok, DISEASE_LABELS, cfg.augment.mean, cfg.augment.std, size,
            max_text_length=cfg.model.max_text_length)
        _, plain_s_probs = plain_session(batches[0]["images"])
        plain_ad = np.concatenate([AdapterEngine(adapter, cfg_b.augment.mean, cfg_b.augment.std,
                                                 size).logits(b["images"]) for b in batches])
        check(dict(_build.LAUNCHES) == before, "a kernel ran during the plain run")
    del adapter, ad
    text, plain_text, s_text, plain_s_text = (
        t.float().cpu().numpy() for t in (engine.text_features, plain.text_features,
                                          session.text_features, plain_session.text_features))
    probs, plain_probs = (1 / (1 + np.exp(-v)) for v in (view_logits, plain_logits))

    def logit(p):  # in float64: float32 probabilities near 0.5 keep ~1e-7 of the logit
        p = p.astype(np.float64)
        return np.log(p / (1 - p))

    # The image half of the route (B2 and the tower) is held below the spread
    # of its outputs between inputs. The text half (B3, B4 in BERT) and the
    # whole route keep their tolerances with their spreads printed: random
    # weights leave the classes' text features as close together as about
    # twice the bf16 route's difference, so neither they nor the logits and
    # probabilities after them can be held below their spread. B1 and B2 at
    # this path's inputs are held below theirs above; B3 and B4 in phase 2.
    print("kernels against their plain versions through the route, from the same weights and "
          "batches:")
    for what, got, want, tol, spreads, bound in (
            ("image half: unit image features (B2)", view_feats, plain_feats,
             TOL["eval_image_features"], {"views": apart(plain_feats)}, True),
            ("image half: InferenceSession's fused features (B2)", fused_feats, plain_fused,
             TOL["eval_image_features"], {"exams": apart(plain_fused)}, True),
            ("image half: AdapterEngine logits (B2)", ad_logits, plain_ad,
             TOL["eval_adapter_logits"], {"views": apart(plain_ad[real])}, True),
            ("text half: the bank's unit text features (B3, B4)", text, plain_text,
             TOL["eval_text_features"], {"classes": apart(plain_text)}, False),
            ("text half: InferenceSession's unit text features (B3, B4)", s_text, plain_s_text,
             TOL["eval_text_features"], {"classes": apart(plain_s_text)}, False),
            ("whole route: zero-shot logits (B1-B4), every view", view_logits, plain_logits,
             TOL["eval_logits"], {"views": apart(plain_logits),
                                  "classes": apart(plain_logits.T)}, False),
            ("whole route: zero-shot probabilities, every view", probs, plain_probs,
             TOL["eval_vs_plain"], {"views": apart(plain_probs)}, False),
            ("whole route: InferenceSession logits (its probabilities' inverse sigmoid)",
             logit(s_probs), logit(plain_s_probs), TOL["eval_session_logits"],
             {"exams": apart(logit(plain_s_probs)), "classes": apart(logit(plain_s_probs).T)},
             False),
            ("whole route: InferenceSession probabilities", s_probs, plain_s_probs,
             TOL["eval_vs_plain"], {"exams": apart(plain_s_probs)}, False)):
        held(what, got, want, tol, spreads, failures, bound=bound)

    # A prediction differs between the routes only through a decision that
    # lies within their difference. Top-k: the k-th against the (k+1)-th
    # softmax probability of a view; an exam whose two views both lie
    # further apart than twice the routes' difference gets the same set.
    # Dynamic thresholds: a class is in an exam's set when its weighted
    # view-max probability clears the class's threshold, unless no class
    # does (the argmax fallback); in an exam where some class clears its
    # threshold by more than the routes' difference in probability and
    # threshold, each class further than that from its threshold is in both
    # sets or in neither. Those decided exams and (exam, class) pairs must
    # agree; the rest are counted.
    def softmax(v):  # in float64, as softmax_topk_predictions computes it
        v = v.astype(np.float64)
        e = np.exp(v - v.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    sm, sm_p = softmax(view_logits), softmax(plain_logits)
    sm_err = float(np.abs(sm - sm_p).max())
    ordered = np.sort(sm, axis=1)[:, ::-1]
    topk_margin = (ordered[:, zc.top_k - 1] - ordered[:, zc.top_k]).reshape(-1, 2).min(1)
    decided = topk_margin > 2 * sm_err
    differ = np.array([set(a) != set(b) for a, b in zip(zs["predictions"], zs_p["predictions"])])
    print(f"run_zero_shot_eval prediction sets: {int(decided.sum())} of {n} exams decided "
          f"(top-{zc.top_k} gap of both views over twice the routes' softmax difference "
          f"{sm_err:.3e}), {int(differ[decided].sum())} of them differ from the plain route's; "
          f"{int(differ[~decided].sum())} of the other {int((~decided).sum())} differ; median "
          f"gap {float(np.median(topk_margin)):.3e}")
    if differ[decided].any():
        failures.append("run_zero_shot_eval: decided prediction sets differ")
    view_w = np.array([zc.frontal_weight, zc.lateral_weight])[:, None]
    w, w_p = ((p.reshape(-1, 2, 16) * view_w).max(1) for p in (probs, plain_probs))
    t_k, t_p = (np.array(list(d["thresholds"].values())) for d in (dyn, dyn_p))
    edge = float(np.abs(w - w_p).max() + np.abs(t_k - t_p).max())
    pairs = ((w - t_k > edge).any(1, keepdims=True)) & (np.abs(w - t_k) > edge)
    calibrated = (t_k != NO_POSITIVES_THRESHOLD) & (t_k != NO_NEGATIVES_THRESHOLD)
    member = dyn["pred_matrix"] != dyn_p["pred_matrix"]
    print(f"run_dynamic_threshold_eval prediction sets: {int(pairs.sum())} of {w.size} (exam, "
          f"class) pairs decided (further than {edge:.3e} from the threshold, the routes' "
          f"difference in probability and threshold, in an exam with a class that clears its "
          f"threshold by more), {int(member[pairs].sum())} of them differ from the plain "
          f"route's; {int(member[~pairs].sum())} of the other {int((~pairs).sum())} differ; "
          f"of the {int(n * calibrated.sum())} pairs of the {int(calibrated.sum())} classes "
          f"with a calibrated threshold (not a fallback), "
          f"{int((np.abs(w - t_k) > edge)[:, calibrated].sum())} lie further than that from it")
    if member[pairs].any():
        failures.append("run_dynamic_threshold_eval: decided (exam, class) pairs differ")
    check(not failures, "; ".join(failures))

    views = 2 * n
    print(f"evaluation from files on {card}: cache build {len(files) / cache_s:.1f} img/s "
          f"({len(files)} PNGs -> {size}x{size} grey, 8 threads, one reading of {cache_s:.2f} s); "
          f"loader {EVAL_PASSES * len(loaded) / loader_s:.2f} batches/s ({EVAL_PASSES} passes of "
          f"{len(loaded)} batches of {EVAL_BATCH} exams from the cache, {loader_s:.2f} s); eval "
          f"{EVAL_PASSES * views / passes_s:.1f} img/s (run_zero_shot_eval, {EVAL_PASSES} passes "
          f"of {views} views from the cache to metrics, {passes_s:.2f} s; the counted first "
          f"pass {views / eval_s:.1f} img/s in {eval_s:.2f} s)")
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


def cli_phase(_build, mods, dev, seed: int, card: str, workdir: str, results: dict) -> dict:
    """Phase 9: the chain from the command line, ``cli.main.main(argv)`` in
    this process, on phase 8's Kaggle layout in ``workdir``; returns the
    launches of the cli paths."""
    import argparse
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    engine_module = importlib.import_module("clip_for_dl_tpu_torch.zeroshot.engine")
    from clip_for_dl_tpu_torch import inference, zeroshot
    from clip_for_dl_tpu_torch.core.config import get_preset
    from clip_for_dl_tpu_torch.core.device import to_device
    from clip_for_dl_tpu_torch.data import DeviceImageCache, read_csv
    from clip_for_dl_tpu_torch.models import CXRClip
    from clip_for_dl_tpu_torch.text import load_vocab
    from clip_for_dl_tpu_torch.tools.day_one import (
        BIO_CLINICALBERT_VOCAB, standin_towers, standin_vocab,
    )
    from clip_for_dl_tpu_torch.train import CheckpointManager, loop
    from clip_for_dl_tpu_torch.zeroshot.engine import ZeroShotEngine

    t_phase = time.perf_counter()
    kaggle, work = f"{workdir}/kaggle", f"{workdir}/cli"
    os.makedirs(work)
    image_dir = f"{kaggle}/images/images_normalized"
    projections = f"{kaggle}/indiana_projections.csv"
    t = time.perf_counter()
    vocab = standin_vocab(f"{kaggle}/indiana_reports.csv", f"{work}/vocab.txt",
                          BIO_CLINICALBERT_VOCAB)
    check(len(load_vocab(vocab)) == BIO_CLINICALBERT_VOCAB == get_preset("pretrain_clip")
          .model.vocab_size, "the stand-in vocab is not at the preset's vocab_size")
    cfg = cli._apply_tiny(get_preset("pretrain_clip"), argparse.Namespace(), BIO_CLINICALBERT_VOCAB)
    image_tower, text_tower = standin_towers(work, cfg.model, seed=seed, device=dev)
    print(f"stand-ins: vocab of {BIO_CLINICALBERT_VOCAB} entries from the layout's reports, "
          f"padded; tower files from a seeded {describe(cfg.model)} in "
          f"{time.perf_counter() - t:.1f} s")

    by_path, walls = {}, {}

    def run(name, argv, path=None):
        """One command in this process; its launches counted under ``path``."""
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}: {out.getvalue()[-2000:]}")
        if path:
            by_path[path] = dict(_build.LAUNCHES)
            check_launched(mods, by_path[path], path)
        torch.cuda.empty_cache()
        print(f"  {name}: exit 0 in {walls[name]:.1f} s on {card}"
              + (f"; launches {by_path[path]}" if path else ""))
        return out.getvalue()

    labeled, cache = f"{work}/labeled.csv", f"{work}/cache"
    run("prep", ["prep", "--reports", f"{kaggle}/indiana_reports.csv", "--out", labeled,
                 "--unlabeled-out", f"{work}/unlabeled.csv"])
    run("cache-images", ["cache-images", "--image-dir", image_dir, "--out", cache,
                         "--projections-csv", projections, "--image-size", "224"])
    n_cached = len(read_csv(projections))
    data = ["--reports-csv", labeled, "--projections-csv", projections, "--image-dir", image_dir,
            "--image-cache", cache, "--vocab", vocab]
    kernels = ["--flash-attention", "--bert-fused-mlp"]
    logs, pre, ad = f"{work}/logs", f"{work}/pretrain", f"{work}/adapter"

    # -- pretrain, the adapter: timed epochs and checkpoint saves ------------------
    epochs, saves, first_step = [], [], {}
    run_epoch, save = loop.run_epoch, CheckpointManager.save

    def timed_epoch(step_fn, state, loader, *a, **kw):
        """The epoch with each step synced and timed: (batch sizes, step s);
        the phase's first step is kept with what it started from."""
        sizes, steps = [], []

        def timed_step(st, batch, *rest):
            if not first_step:
                gen = rest[-1] if isinstance(rest[-1], torch.Generator) else None
                first_step.update(
                    step=step_fn, state=st, rest=rest,
                    batch={k: v.clone() if torch.is_tensor(v) else np.array(v, copy=True)
                           for k, v in batch.items()},
                    weights={k: v.detach().clone() for k, v in st.model.state_dict().items()},
                    optimizer=copy.deepcopy(st.optimizer.state_dict()),
                    generator=None if gen is None else gen.get_state())
            t0 = time.perf_counter()
            out = step_fn(st, batch, *rest)
            torch.cuda.synchronize(dev)
            steps.append(time.perf_counter() - t0)
            sizes.append(batch["images"].shape[0])
            return out

        out = run_epoch(timed_step, state, loader, *a, **kw)
        epochs.append((sizes, steps))
        return out

    def timed_save(self, *a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        save(self, *a, **kw)
        saves.append((time.perf_counter() - t0) * 1e3)

    train_kernels = dict.fromkeys(("flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd"))
    stack, pretrain_in = first_inputs(mods, train_kernels)
    with mock.patch.object(loop, "run_epoch", timed_epoch), \
            mock.patch.object(CheckpointManager, "save", timed_save):
        with stack:
            run("pretrain", ["pretrain", *data, *kernels, "--epochs", "1", "--device-cache",
                             "--bucket-text", "--length-grouped", "--init-image-tower",
                             image_tower, "--init-text-tower", text_tower, "--checkpoint-dir",
                             pre, "--log-dir", logs], "cli_pretrain")
        pre_epoch, pre_saves = epochs.pop(), list(saves)
        saves.clear()
        run("adapter", ["adapter", *data, *kernels, "--epochs", "1", "--checkpoint", pre,
                        "--checkpoint-dir", ad, "--log-dir", logs], "cli_adapter")
    with open(f"{logs}/training_history.csv", newline="") as f:
        history = list(csv.DictReader(f))
    check(len(history) == 1 and all(np.isfinite(float(history[0][k]))
                                    for k in ("train_loss", "val_loss")), f"history {history}")
    def rate(epoch):
        sizes, steps = epoch
        k = min(1, len(steps) - 1)  # steps after the first, where there are any
        return (f"{sum(sizes[k:]) / sum(steps[k:]):.1f} samples/s over steps {k}-"
                f"{len(steps) - 1} of B = {sizes[0]} (each synced; step 0 "
                f"{steps[0] * 1e3:.1f} ms, the epoch's {len(steps)} steps {sum(steps):.2f} s)")

    print(f"pretrain (--device-cache --bucket-text --length-grouped) on {card}: "
          f"{rate(pre_epoch)}; checkpoint save {[round(x, 1) for x in pre_saves]} "
          f"ms; history {history[0]}")
    print(f"adapter on {card}: {rate(epochs[-1])}; checkpoint save "
          f"{[round(x, 1) for x in saves]} ms")

    # -- zeroshot, counted, with what the route comparison needs --------------------
    def recorders():
        """Patches recording the kernel inputs (B2's first batch, B1's first
        call), the unit image features, the bank and the logits of a
        zeroshot run."""
        rec = {"prep": [], "sim": [], "feats": [], "logits": [], "text": []}
        prep_fn, sim_fn = engine_module.preprocess_images, engine_module.similarity
        encode, dispatch = CXRClip.encode_image, ZeroShotEngine._dispatch
        build = ZeroShotEngine.build_text_features

        def rec_prep(images, *a, **kw):
            if not rec["prep"]:
                rec["prep"].append((images.clone(), a, kw))
            return prep_fn(images, *a, **kw)

        def rec_sim(a, b, t):
            if not rec["sim"]:
                rec["sim"].append((a.clone(), b.clone(), t))
            return sim_fn(a, b, t)

        def rec_encode(self, images, **kw):
            out = encode(self, images, **kw)
            rec["feats"].append(out.detach().float().clone())
            return out

        def rec_dispatch(self, images):
            out, n = dispatch(self, images)
            rec["logits"].append(out.clone())
            return out, n

        def rec_build(self, prompts):
            rec["text"].append(build(self, prompts).clone())
            return rec["text"][-1]

        stack = ExitStack()
        for owner, name, fn in ((engine_module, "preprocess_images", rec_prep),
                                (engine_module, "similarity", rec_sim),
                                (CXRClip, "encode_image", rec_encode),
                                (ZeroShotEngine, "_dispatch", rec_dispatch),
                                (ZeroShotEngine, "build_text_features", rec_build)):
            stack.enter_context(mock.patch.object(owner, name, fn))
        return stack, rec

    driver_s = []
    run_zs = zeroshot.run_zero_shot_eval

    def timed_driver(*a, **kw):
        t0 = time.perf_counter()
        out = run_zs(*a, **kw)
        torch.cuda.synchronize(dev)
        driver_s.append(time.perf_counter() - t0)
        return out

    zs = ["zeroshot", *data, *kernels, "--checkpoint", pre]
    stack, kernel_rec = recorders()
    bank_kernels = dict.fromkeys(("flash_attention", "mlp"))
    bank_stack, bank_in = first_inputs(mods, bank_kernels)
    with stack, bank_stack, mock.patch.object(zeroshot, "run_zero_shot_eval", timed_driver):
        run("zeroshot", [*zs, "--log-dir", f"{work}/zs"], "cli_zeroshot")
    with open(f"{work}/zs/zero_shot_results.csv", newline="") as f:
        n_val = len(list(csv.reader(f))) - 1
    views = 2 * n_val
    print(f"zeroshot on {card}: {views / driver_s[-1]:.1f} views/s (run_zero_shot_eval over "
          f"{n_val} exams of the validation split, from the cache to metrics, "
          f"{driver_s[-1]:.2f} s; the command {walls['zeroshot']:.1f} s with the model's "
          f"load and the prompt bank)")
    run("zeroshot --dynamic", [*zs, "--dynamic", "--log-dir", f"{work}/zs_dyn"],
        "cli_zeroshot_dynamic")
    with open(f"{work}/zs_dyn/thresholds.json") as f:
        check(len(json.load(f)) == 16, "thresholds.json")

    # -- eval, both heads; the three weight sources ------------------------------------
    def eval_csv(name, argv, path=None):
        log = f"{work}/{name.replace(' ', '_').replace('.', '')}"
        out = run(name, [*argv, "--log-dir", log], path)
        with open(f"{log}/eval_predictions.csv", "rb") as f:
            return out, f.read()

    ev = ["eval", *data, *kernels]
    out, by_dir = eval_csv("eval", [*ev, "--checkpoint", ad, "--bootstrap", "50"], "cli_eval")
    check('"bootstrap_ci_95"' in out, "eval --bootstrap printed no intervals")
    _, adapter_csv = eval_csv("eval --head adapter", [*ev, "--checkpoint", ad, "--head",
                                                      "adapter"], "cli_eval_adapter")
    for ext in ("pth", "safetensors"):
        run(f"convert .{ext}", ["convert", "--vocab", vocab, "--checkpoint", ad, "--out",
                                f"{work}/model.{ext}"])
    sources = {".pth": eval_csv("eval .pth", [*ev, "--checkpoint", f"{work}/model.pth"])[1],
               ".safetensors": eval_csv("eval .safetensors",
                                        [*ev, "--checkpoint", f"{work}/model.safetensors"])[1]}
    rows = by_dir.count(b"\n") - 1
    check(rows == n_val and all(v == by_dir for v in sources.values()),
          "eval on the checkpoint directory, the .pth and the .safetensors differ")
    print(f"eval on the adapter's checkpoint directory, its .pth and its .safetensors: "
          f"eval_predictions.csv ({rows} exams x 16 probabilities) byte-equal")

    # -- the device cache: the same bytes through the same B2 --------------------------
    gathered, reached = [], []
    gather = DeviceImageCache.gather

    def rec_gather(self, r):
        out = gather(self, r)
        gathered.append(out.data_ptr())
        return out

    def rec_to_device(images, device):
        reached.append(images)
        out = to_device(images, device)
        check(not torch.is_tensor(images) or out is images, "to_device moved a device batch")
        return out

    stack, cached_rec = recorders()
    with stack, mock.patch.object(DeviceImageCache, "gather", rec_gather), \
            mock.patch.object(engine_module, "to_device", rec_to_device), \
            mock.patch.object(inference, "to_device", rec_to_device):
        run("zeroshot --device-cache", [*zs, "--device-cache", "--log-dir", f"{work}/zs_dc"])
        _, adapter_dc = eval_csv("eval --head adapter --device-cache",
                                 [*ev, "--checkpoint", ad, "--head", "adapter", "--device-cache"])
    check(len(cached_rec["logits"]) == len(kernel_rec["logits"]) and all(
        torch.equal(a, b) for a, b in zip(cached_rec["logits"], kernel_rec["logits"])),
        "zeroshot --device-cache logits differ from the streamed feed's")
    check(adapter_dc == adapter_csv, "eval --head adapter --device-cache differs from the "
                                     "streamed feed")
    check(reached and all(torch.is_tensor(x) and x.device.type == dev.type for x in reached)
          and {x.data_ptr() for x in reached} <= set(gathered),
          "a gathered batch reached the model through the host")
    print(f"--device-cache: zeroshot logits ({sum(len(x) for x in kernel_rec['logits'])} views) "
          f"and eval --head adapter's CSV bit-equal to the streamed feed; all {len(reached)} "
          f"batches reached the model as the gathered device tensors")

    # -- the ViT preset, B9 on the command line path -------------------------------------
    vit_kernels = {"flash_attention": lambda a, kw: a[0].shape[1] == VIT_TOKENS,
                   "mlp_block": None}  # B3 in the image tower, not in the bank
    stack, vit_in = first_inputs(mods, vit_kernels)
    with stack:
        run("zeroshot --preset vit", ["zeroshot", *data, *kernels, "--preset", "vit",
                                      "--fused-mlp", "--log-dir", f"{work}/zs_vit"],
            "cli_zeroshot_vit")

    # -- zeroshot against itself on the plain route ---------------------------------------
    stack, plain_rec = recorders()
    with stack, plain_kernels(mods):
        run("zeroshot, plain route", [*zs, "--log-dir", f"{work}/zs_plain"])
        check(not _build.LAUNCHES, f"a kernel ran during the plain run: {_build.LAUNCHES}")
    failures: list = []
    prep, sim = mods["image_prep"], mods["similarity"]
    grey, a, kw = kernel_rec["prep"][0]
    x_ref = prep.preprocess_reference(grey, *a, **kw)
    x = prep.preprocess_images(grey, *a, **kw)
    neighbour = float((x_ref[:, :, 1:].float() - x_ref[:, :, :-1].float()).abs().median())
    print("phase 9, kernels against their plain versions at the zeroshot command's inputs, "
          "and the command against itself on the plain route:")
    held(f"B2 on the command's first batch {list(grey.shape)} uint8 -> {list(x.shape)}",
         x, x_ref, TOL["image_prep"], {"a pixel and its neighbour (median)": neighbour},
         failures, results, "image_prep")
    f, b, T = kernel_rec["sim"][0]
    want = sim.similarity_reference(f, b, T)
    held(f"B1 at the command's inputs {list(f.shape)} x {list(b.shape)}, T = {T}",
         sim.similarity(f, b, T), want, TOL["similarity"],
         {"rows": apart(want), "classes": apart(want.T)}, failures, results, "similarity")
    real = slice(0, views)
    feats, plain_feats = (torch.cat(r["feats"])[real] for r in (kernel_rec, plain_rec))
    logits, plain_logits = (torch.cat(r["logits"])[real].float().cpu().numpy()
                            for r in (kernel_rec, plain_rec))
    text, plain_text = kernel_rec["text"][0], plain_rec["text"][0]
    probs, plain_probs = (1 / (1 + np.exp(-v)) for v in (logits, plain_logits))
    for what, got, want_, tol, spreads, bound in (
            ("image half: unit image features (B2)", feats, plain_feats,
             TOL["eval_image_features"], {"views": apart(plain_feats)}, True),
            ("text half: the bank's unit text features (B3, B4)", text, plain_text,
             TOL["eval_text_features"], {"classes": apart(plain_text)}, False),
            ("whole route: zero-shot logits (B1-B4), every view", logits, plain_logits,
             TOL["eval_logits"], {"views": apart(plain_logits),
                                  "classes": apart(plain_logits.T)}, False),
            ("whole route: zero-shot probabilities, every view", probs, plain_probs,
             TOL["eval_vs_plain"], {"views": apart(plain_probs)}, False)):
        held(what, got, want_, tol, spreads, failures, bound=bound)
    check(not failures, "; ".join(failures))
    print("phase 9, the kernels of the other commands against their plain versions at the "
          "first inputs each command gave them:")
    hold_first_inputs(mods, pretrain_in, train_kernels, "pretrain", results)
    hold_first_inputs(mods, bank_in, bank_kernels, "zeroshot's prompt bank", results)
    hold_first_inputs(mods, vit_in, vit_kernels, "zeroshot --preset vit", results)
    print("phase 9, pretrain's first step against the plain route (phase 4's check):")
    step_against_plain(_build, mods, first_step,
                       [g.name for g in get_preset("pretrain_clip").train.groups])
    print(f"phase 9 on {card}: cache build {n_cached / walls['cache-images']:.1f} img/s "
          f"({n_cached} PNGs -> 224x224 grey, the command's wall time); command wall times "
          f"{json.dumps({k: round(v, 2) for k, v in walls.items()})} s")
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


# the command ``python -m clip_for_dl_tpu_torch`` in a child process that
# writes the kernel launches it counted to the file named first (phase 10)
SERVE_CHILD = (
    "import atexit, json, runpy, sys\n"
    "from clip_for_dl_tpu_torch.ops import _build\n"
    "path = sys.argv.pop(1)\n"
    "atexit.register(lambda: json.dump(dict(_build.LAUNCHES), open(path, 'w')))\n"
    "sys.argv[0] = 'clip_for_dl_tpu_torch'\n"
    "runpy.run_module('clip_for_dl_tpu_torch', run_name='__main__', alter_sys=True)\n"
)
SERVE_PNGS = 32  # distinct layout PNGs the server is sent
SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 16  # the concurrent pass
BURST = 96  # clients that post at once at the adapter server (--buckets 1 --max-pending 8)


class Served:
    """``serve`` in a child process on this machine: the bound port from its
    "serving on" line, its log collected by a reader thread, HTTP requests
    to it, and SIGINT to stop it."""

    def __init__(self, argv: list, launches_path: str, env: dict, ranks: int = 0,
                 script: str = ""):
        """With ``ranks``: ``torchrun --standalone`` of ``script`` (SERVE_CHILD
        that formats ``{rank}`` in the launches path) as that many ranks."""
        import re
        import threading

        head = [sys.executable, "-c", SERVE_CHILD]
        if ranks:
            head = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    f"--nproc-per-node={ranks}", script]
        self.proc = subprocess.Popen(
            [*head, launches_path, *argv], cwd=str(ROOT), env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        self.lines, self.port = [], None
        found = threading.Event()

        def read():
            for line in self.proc.stderr:
                self.lines.append(line)
                m = re.search(r"serving on http://[\d.]+:(\d+)", line)
                if m:
                    self.port = int(m.group(1))
                    found.set()
            found.set()

        threading.Thread(target=read, daemon=True).start()
        found.wait(300)
        if self.port is None:
            self.proc.kill()
            self.proc.wait()
        first = next((i for i, line in enumerate(self.lines) if "Traceback" in line), 0)
        check(self.port is not None, "serve did not bind: " + "".join(
            self.lines[first:first + 40] + ["...\n"] + self.lines[-10:]))

    def request(self, method: str, path: str, body=None, ctype="image/png"):
        """(status, headers, JSON body, client seconds)."""
        import http.client

        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": ctype} if body is not None else {})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            return resp.status, dict(resp.getheaders()), payload, time.perf_counter() - t0
        finally:
            conn.close()

    def stop(self, sig=None) -> int:
        import signal

        self.proc.send_signal(signal.SIGINT if sig is None else sig)
        try:
            return self.proc.wait(120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            return -9


def busy_sampler():
    """nvidia-smi sampling the card's utilization (the share of each 100 ms
    in which a kernel ran) until the returned stop function is called,
    which returns the samples."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop():
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        return [int(v) for v in out.split() if v.strip().isdigit()]

    return stop


def pct(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def serve_phase10(_build, mods, dev, seed: int, card: str, workdir: str,
                  results: dict) -> dict:
    """Phase 10: the HTTP server, the report-built banks and the rest of the
    pretrain options on phase 9's layout, vocab, adapter directory and
    thresholds.json; returns the launches of its paths."""
    import argparse
    import base64
    import importlib
    import io
    import os
    import threading
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    steps_module = importlib.import_module("clip_for_dl_tpu_torch.train.steps")
    train_package = importlib.import_module("clip_for_dl_tpu_torch.train")
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.data.frame import read_csv, rename
    from clip_for_dl_tpu_torch.inference import AdapterEngine, load_trained_model
    from clip_for_dl_tpu_torch.serving import decode_request_image
    from clip_for_dl_tpu_torch.testing.png import encode_png
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.train import loop
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t_phase = time.perf_counter()
    kaggle, work9, work = f"{workdir}/kaggle", f"{workdir}/cli", f"{workdir}/serve"
    os.makedirs(work)
    vocab, ad, thresholds = f"{work9}/vocab.txt", f"{work9}/adapter", f"{work9}/zs_dyn/thresholds.json"
    image_dir = f"{kaggle}/images/images_normalized"
    data = ["--reports-csv", f"{work9}/labeled.csv", "--projections-csv",
            f"{kaggle}/indiana_projections.csv", "--image-dir", image_dir,
            "--image-cache", f"{work9}/cache", "--vocab", vocab]
    kernels = ["--flash-attention", "--bert-fused-mlp"]
    by_path, failures = {}, []
    tok = BertTokenizer(vocab, do_lower_case=False)
    cfg = cli._apply_tiny(get_preset("zero_shot"), argparse.Namespace(
        flash_attention=True, bert_fused_mlp=True), len(tok.vocab))
    size = cfg.model.image_size
    with open(thresholds) as f:
        thr = json.load(f)
    thr_vec = np.array([thr.get(d, 0.5) for d in DISEASE_LABELS])

    # -- the bodies: layout PNGs, raw and as JSON ----------------------------------------
    names = sorted(n for n in os.listdir(image_dir) if n.endswith(".png"))
    pngs = []
    for n in names:
        with open(f"{image_dir}/{n}", "rb") as f:
            raw = f.read()
        if raw[:8] == b"\x89PNG\r\n\x1a\n":
            pngs.append(raw)
        if len(pngs) == SERVE_PNGS:
            break

    def body(i, as_json):
        raw = pngs[i % len(pngs)]
        if as_json:
            return json.dumps({"image_b64": base64.b64encode(raw).decode()}).encode(), \
                "application/json"
        return raw, "image/png"

    t0 = time.perf_counter()
    decoded = [decode_request_image(b, "image/png", size) for b in pngs]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(pngs)
    shapes = sorted({(int.from_bytes(b[20:24], "big"), int.from_bytes(b[16:20], "big"))
                     for b in pngs})

    # -- 1. serve, the zero_shot preset ----------------------------------------------------
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if dev.type == "cuda":  # the child takes the card, as the smoke does
        env.pop("CLIP_FOR_DL_TPU_FORCE_CPU", None)
    torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    served = Served(["serve", "--vocab", vocab, *kernels, "--checkpoint", ad, "--thresholds",
                     thresholds, "--host", "127.0.0.1", "--port", "0", "--max-pending", "8",
                     "--log-dir", f"{work}/logs"], f"{work}/launches_serve.json", env)
    start_s = time.perf_counter() - t_start
    answers = []  # (image index, status, payload, seconds)
    try:
        status, _, health, _ = served.request("GET", "/healthz")
        check(status == 200 and health["diseases"] == list(DISEASE_LABELS)
              and health["buckets"] == [1, 4, 16, 64], f"/healthz {status} {health}")
        t0 = time.perf_counter()
        for i in range(len(pngs)):
            st, _, payload, sec = served.request("POST", "/predict", *body(i, i % 2 == 1))
            answers.append((i, st, payload, sec))
        sequential_s = time.perf_counter() - t0
        concurrent = [None] * (SERVE_CLIENTS * SERVE_PER_CLIENT)

        def client(c):
            for j in range(SERVE_PER_CLIENT):
                k = c * SERVE_PER_CLIENT + j
                st, _, payload, sec = served.request("POST", "/predict", *body(k, (c + j) % 2))
                concurrent[k] = (k % len(pngs), st, payload, sec)

        stop_sampler = busy_sampler()
        try:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            concurrent_s = time.perf_counter() - t0
        finally:
            busy = stop_sampler()
        answers += concurrent
        odd = {"garbage": served.request("POST", "/predict", os.urandom(4096)),
               "non-PNG": served.request("POST", "/predict",
                                         b"RIFF\0\x10\0\0WEBP" + os.urandom(4084),
                                         "image/webp"),
               "no route": served.request("POST", "/classify", pngs[0]),
               "no route (GET)": served.request("GET", "/metrics")}
        stats = served.request("GET", "/stats")[2]
    finally:
        rc = served.stop()
    with open(f"{work}/launches_serve.json") as f:
        by_path["cli_serve"] = json.load(f)
    check(rc == 0, f"serve exited with {rc} on SIGINT: {''.join(served.lines[-20:])}")
    check_launched(mods, by_path["cli_serve"], "cli_serve")
    check(all(a[1] == 200 for a in answers), "a /predict request failed: "
          + str([a[:3] for a in answers if a[1] != 200][:3]))
    for what, want in (("garbage", 400), ("non-PNG", 400), ("no route", 404),
                       ("no route (GET)", 404)):
        check(odd[what][0] == want, f"{what}: {odd[what][0]} {odd[what][2]}")
    check("A2c" in odd["non-PNG"][2]["error"], f"non-PNG: {odd['non-PNG'][2]}")
    check(stats["requests"] == len(answers) and stats["shed"] == 0,
          f"/stats counts {stats['requests']} requests, {stats['shed']} shed; sent {len(answers)}")
    client_ms = [a[3] * 1e3 for a in concurrent]
    print(f"serve (zero_shot, {describe(cfg.model)}, bf16, --thresholds, buckets 1/4/16/64, "
          f"--max-pending 8) on {card}: up in {start_s:.1f} s (process, model, bank, warm-up); "
          f"exit 0 on SIGINT; launches {by_path['cli_serve']}")
    print(f"  {len(pngs)} PNGs {shapes} grey, sequential: {len(pngs) / sequential_s:.1f} req/s; "
          f"{SERVE_CLIENTS} clients x {SERVE_PER_CLIENT}, raw and JSON: "
          f"{len(concurrent) / concurrent_s:.1f} req/s, client p50 {pct(client_ms, 50):.1f} "
          f"p99 {pct(client_ms, 99):.1f} ms; the server's queue {stats['queue_ms']}, assemble "
          f"{stats['assemble_ms']}, fetch {stats['fetch_ms']} ms, batch sizes "
          f"{stats['batch_size_hist']}; the decode {decode_ms:.2f} ms a request in one thread "
          f"(this process); the card busy {np.mean(busy) if busy else float('nan'):.1f}% of "
          f"the concurrent pass ({len(busy)} nvidia-smi samples at 100 ms)")
    print(f"  garbage {odd['garbage'][0]}, non-PNG {odd['non-PNG'][0]} "
          f"({odd['non-PNG'][2]['error']!r}), unknown routes {odd['no route'][0]} / "
          f"{odd['no route (GET)'][0]}; /stats requests {stats['requests']}, shed "
          f"{stats['shed']}")

    # the plain route on the same decoded images, from the same weights
    model = load_trained_model(ad, cfg, torch.bfloat16, device=dev)
    engine = ZeroShotEngine(model, tok, DISEASE_LABELS, cfg.zeroshot, cfg.augment.mean,
                            cfg.augment.std, size, cfg.model.max_text_length, torch.bfloat16)
    with plain_kernels(mods):
        before = dict(_build.LAUNCHES)
        engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
        plain = np.concatenate([engine.probs(np.stack(decoded[i:i + 16]))
                                for i in range(0, len(decoded), 16)])
        check(dict(_build.LAUNCHES) == before, "a kernel ran on the plain route")
    got = np.array([[a[2]["probs"][d] for d in DISEASE_LABELS] for a in answers])
    want = plain[[a[0] for a in answers]]
    err = float(np.abs(got - want).max())
    edge = np.abs(want - thr_vec)
    decided = edge > err
    server_sets = np.array([[d in a[2]["predictions"] for d in DISEASE_LABELS] for a in answers])
    differ = server_sets != (want > thr_vec)
    held("every 200 answer's probabilities against the plain route on its decoded image",
         got, want, TOL["probs_vs_plain"], {"images": apart(plain)}, failures, bound=False)
    print(f"  predictions: {int(decided.sum())} of {decided.size} (answer, class) pairs decided "
          f"(further than {err:.3e} from their threshold), {int(differ[decided].sum())} of them "
          f"differ from the plain route's; {int(differ[~decided].sum())} undecided differ")
    if differ[decided].any():
        failures.append("serve: decided predictions differ from the plain route's")

    # -- 2. serve --head adapter, and the burst past --max-pending ----------------------------
    served = Served(["serve", "--vocab", vocab, "--head", "adapter", "--checkpoint", ad,
                     "--buckets", "1", "--max-pending", "8", "--host", "127.0.0.1", "--port",
                     "0", "--log-dir", f"{work}/logs_adapter"],
                    f"{work}/launches_adapter.json", env)
    try:
        short = [served.request("POST", "/predict", *body(i, i % 2 == 0)) for i in range(8)]
        tiny = encode_png(np.random.default_rng(seed).integers(0, 256, (16, 16), np.uint8))
        burst = [None] * BURST
        go = threading.Event()

        def poster(k):
            go.wait()
            burst[k] = served.request("POST", "/predict", tiny)

        threads = [threading.Thread(target=poster, args=(k,)) for k in range(BURST)]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join()
        stats = served.request("GET", "/stats")[2]
    finally:
        rc = served.stop()
    with open(f"{work}/launches_adapter.json") as f:
        by_path["cli_serve_adapter"] = json.load(f)
    check(rc == 0, f"serve --head adapter exited with {rc} on SIGINT")
    check_launched(mods, by_path["cli_serve_adapter"], "cli_serve_adapter")
    codes = [b[0] for b in burst]
    shed = codes.count(429)
    check(all(a[0] == 200 for a in short) and set(codes) <= {200, 429} and shed >= 1
          and all(b[1].get("Retry-After") == "1" for b in burst if b[0] == 429),
          f"adapter server: {[a[0] for a in short]}, burst {sorted(set(codes))} ({shed} shed)")
    check(stats["shed"] == shed and stats["requests"] == len(short) + codes.count(200),
          f"adapter /stats {stats['requests']} requests, {stats['shed']} shed")
    adapter = AdapterEngine(load_trained_model(ad, cfg, torch.bfloat16, device=dev),
                            cfg.augment.mean, cfg.augment.std, size, torch.bfloat16)
    with plain_kernels(mods):
        want = adapter.probs(np.stack(decoded[:8]))
    got = np.array([[a[2]["probs"][d] for d in DISEASE_LABELS] for a in short])
    held("serve --head adapter: 8 answers against AdapterEngine on the plain route", got, want,
         TOL["eval_vs_plain"], {"images": apart(want)}, failures, bound=False)
    print(f"serve --head adapter (--buckets 1 --max-pending 8) on {card}: {BURST} clients at "
          f"once: {codes.count(200)} answered 200, {shed} shed with 429 + Retry-After: 1; "
          f"launches {by_path['cli_serve_adapter']}")

    # -- 3. the findings and rich banks from the layout's reports ------------------------------
    reports = read_csv(f"{kaggle}/indiana_reports.csv")
    banks = {"findings": prompts_for_family("findings", DISEASE_LABELS,
                                            rename(reports, {"findings": "Findings"})),
             "rich": prompts_for_family("rich", DISEASE_LABELS, reports)}
    _build.reset_launches()
    feats = {}
    for family, prompts in banks.items():
        flat = [p for d in DISEASE_LABELS for p in prompts[d]]
        lengths = tok.encode(flat, max_length=cfg.model.max_text_length)["attention_mask"].sum(1)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        feats[family] = engine.build_text_features(prompts).clone()
        torch.cuda.synchronize(dev)
        print(f"the {family} bank: {len(flat)} prompts, tokens min {lengths.min()} median "
              f"{int(np.median(lengths))} max {lengths.max()}, encoded in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms on {card}")
    by_path["cli_banks"] = dict(_build.LAUNCHES)
    check_launched(mods, by_path["cli_banks"], "cli_banks")
    with plain_kernels(mods):
        for family, prompts in banks.items():
            want = engine.build_text_features(prompts)
            held(f"the {family} bank's unit text features (B3, B4) against the plain route",
                 feats[family], want, TOL["eval_text_features"], {"classes": apart(want)},
                 failures, bound=False)
    del engine, adapter, model
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))

    # -- 4. pretrain with the A3b options, in this process --------------------------------------
    walls, epochs, first, ema_ms, scales = {}, [], {}, [], []
    run_epoch, update_ema = loop.run_epoch, steps_module.update_ema
    cap = float(np.float32(np.log(100.0)))

    def run(name, argv, path=None):
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}: {out.getvalue()[-2000:]}")
        if path:
            by_path[path] = dict(_build.LAUNCHES)
            check_launched(mods, by_path[path], path)
        print(f"  {name}: exit 0 in {walls[name]:.1f} s on {card}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
              + (f"; launches {by_path[path]}" if path else ""))
        torch.cuda.empty_cache()
        return out.getvalue()

    def timed_epoch(step_fn, state, loader, *a, **kw):
        sizes, secs = [], []

        def timed_step(st, batch, *rest):
            if not first:
                gen = rest[-1] if isinstance(rest[-1], torch.Generator) else None
                first.update(
                    step=step_fn, state=st, rest=rest,
                    batch={k: v.clone() if torch.is_tensor(v) else np.array(v, copy=True)
                           for k, v in batch.items()},
                    weights={k: v.detach().clone() for k, v in st.model.state_dict().items()},
                    optimizer=copy.deepcopy(st.optimizer.state_dict()),
                    generator=None if gen is None else gen.get_state())
            t0 = time.perf_counter()
            out = step_fn(st, batch, *rest)
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
            sizes.append(batch["images"].shape[0])
            scales.append(float(st.model.logit_scale.detach()))
            first["optimizer_state"] = st.optimizer.state
            return out

        out = run_epoch(timed_step, state, loader, *a, **kw)
        epochs.append((sizes, secs))
        return out

    def timed_ema(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        update_ema(*a, **kw)
        torch.cuda.synchronize(dev)
        ema_ms.append((time.perf_counter() - t0) * 1e3)

    def moment_bytes():
        return sum(s["exp_avg"].nbytes for s in first["optimizer_state"].values())

    def rate():
        sizes, secs = epochs[-1]
        k = min(1, len(secs) - 1)
        return (f"{sum(sizes[k:]) / sum(secs[k:]):.1f} samples/s over steps {k}-"
                f"{len(secs) - 1} of B = {sizes[0]} (each synced; step 0 {secs[0] * 1e3:.1f} ms)")

    made, splits = [], {}
    make_real = train_package.make_clip_pretrain_step

    def make_step(*a, **kw):  # the command's step, and what it was built from
        made.append((a, kw))
        return make_real(*a, **kw)

    groups = [g.name for g in get_preset("pretrain_clip").train.groups]
    pre, logs = f"{work}/pretrain_ema", f"{work}/logs_pretrain"
    train_kernels = dict.fromkeys(("flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd"))
    moments = {}
    for name, argv, path in (
            ("pretrain --loss siglip --learnable-temperature --ema-decay 0.999 --bf16-moments "
             "--device-cache",
             ["pretrain", *data, *kernels, "--epochs", "1", "--device-cache", "--loss", "siglip",
              "--learnable-temperature", "--ema-decay", "0.999", "--bf16-moments",
              "--checkpoint-dir", pre, "--log-dir", logs], "cli_pretrain_a3b"),
            ("pretrain --loss info_nce --learnable-temperature (64 synthetic pairs)",
             ["pretrain", "--vocab", vocab, *kernels, "--epochs", "1", "--synthetic",
              "--synthetic-samples", "64", "--loss", "info_nce", "--learnable-temperature",
              "--log-dir", f"{work}/logs_info_nce"], "cli_pretrain_info_nce")):
        first.clear()
        scales.clear()
        made.clear()
        stack, kept = first_inputs(mods, train_kernels)
        with mock.patch.object(loop, "run_epoch", timed_epoch), \
                mock.patch.object(steps_module, "update_ema", timed_ema), \
                mock.patch.object(train_package, "make_clip_pretrain_step", make_step), stack:
            run(name, argv, path)
        check(scales and max(scales) <= cap, f"{name}: logit_scale above log 100: {scales}")
        moments[path] = moment_bytes()
        print(f"  {rate()}; logit_scale after each step in [{min(scales):.6f}, "
              f"{max(scales):.6f}] (cap {cap:.6f}); exp_avg {moments[path] / 1e6:.1f} MB")
        check(len(made) == 1, f"{name} built {len(made)} pretrain steps")
        (a, kw), = made
        made.clear()
        first.update(loss_name=a[3], temperature=a[4])
        model, opt = first["state"].model, first["state"].optimizer
        split, last = step_split(
            dev, first, {"prep": (steps_module, "preprocess_images"),
                         "forward": (model, "forward"),
                         "clip": (steps_module, "clip_by_global_norm_"),
                         "optimizer": (opt, "step"), "ema": (steps_module, "update_ema")},
            {"loss_backward": ("forward", "clip")})
        split["loss_alone"] = loss_alone(dev, first, steps_module, last["forward"])
        splits[path] = split
        del model, opt, last
        print(f"  the step in parts, ms (median of 5, synced at each part's bounds): "
              f"{json.dumps({k: round(v, 3) for k, v in split.items()})}")
        print(f"phase 10, {path}: B3, B6, B4, B8 at the run's first inputs, and its first step "
              f"against the plain route and on the fp32 route:")
        hold_first_inputs(mods, kept, train_kernels, path, results)
        a3b_first_step(_build, mods, first, groups,
                       make_real(*a, **{**kw, "compute_dtype": torch.float32, "ema_decay": 0.0}))
        del a, kw
        first.clear()  # the run's model and optimizer go before the next run's peak
        kept.clear()
        torch.cuda.empty_cache()
    a3b, fp32 = moments["cli_pretrain_a3b"], moments["cli_pretrain_info_nce"]
    check(2 * a3b == fp32, f"exp_avg bytes {a3b} (bf16) vs {fp32} (fp32)")
    print(f"  --bf16-moments: exp_avg {a3b / 1e6:.1f} MB against {fp32 / 1e6:.1f} MB in fp32 "
          f"({(fp32 - a3b) / 1e6:.1f} MB less); the EMA update {np.median(ema_ms):.3f} ms a "
          f"step (median of {len(ema_ms)}, synced)")
    sa, si = splits["cli_pretrain_a3b"], splits["cli_pretrain_info_nce"]
    print(f"  the optimizer step {sa['optimizer']:.3f} ms (AdamWBf16FirstMoment) against "
          f"{si['optimizer']:.3f} ms (AdamW, fp32 moments); the loss alone, forward and "
          f"backward, {sa['loss_alone']:.3f} ms (siglip) and {si['loss_alone']:.3f} ms "
          f"(info_nce); the whole step so split {sa['step']:.3f} and {si['step']:.3f} ms")

    # -- 5. eval --use-ema and convert --use-ema --------------------------------------------------
    ev = ["eval", *data, *kernels]

    def eval_csv(name, argv, path=None):
        log = f"{work}/{name.replace(' ', '_').replace('-', '').replace('.', '')}"
        run(name, [*argv, "--log-dir", log], path)
        with open(f"{log}/eval_predictions.csv", "rb") as f:
            return f.read()

    slot = eval_csv("eval --use-ema", [*ev, "--checkpoint", pre, "--use-ema"], "cli_eval_ema")
    run("convert --use-ema", ["convert", "--vocab", vocab, "--checkpoint", pre, "--use-ema",
                              "--out", f"{work}/ema.pth"])
    converted = eval_csv("eval ema.pth", [*ev, "--checkpoint", f"{work}/ema.pth"])
    live = eval_csv("eval, live weights", [*ev, "--checkpoint", pre])
    check(slot == converted and slot != live, "eval --use-ema and the converted .pth differ, or "
                                              "the EMA scores as the live weights")
    try:
        with redirect_stdout(io.StringIO()):
            cli.main([*ev, "--checkpoint", f"{work9}/pretrain", "--use-ema", "--log-dir",
                      f"{work}/no_ema"])
        raise SmokeFailure("eval --use-ema on a directory without the slot did not fail")
    except ValueError as exc:
        check("the EMA slot of checkpoint" in str(exc) and "lacks" in str(exc), str(exc))
        print(f"  eval --use-ema on phase 9's pretrain directory: ValueError {str(exc)[:120]!r}")
    rows = slot.count(b"\n") - 1
    print(f"eval --use-ema and eval of the .pth that convert --use-ema wrote: "
          f"eval_predictions.csv ({rows} exams) byte-equal; the live weights score otherwise")
    print(f"phase 10 on {card}: command wall times "
          f"{json.dumps({k: round(v, 2) for k, v in walls.items()})} s")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


def multiview_first_step(_build, mods, first: dict, groups, encode_bank, step32,
                         name: str) -> None:
    """Phase 11's check on the first step of a train run (first_step_routes
    with each route's own prompt bank, and the fp32 route from ``step32``):
    the kernels' bank is the command's bit for bit and within
    eval_text_features of the plain route's (the bf16 guard on B3 and B4
    at 512 tokens); the loss within train_first_loss_rel of the plain
    route's, or within the preset's own bound (train_first_own, from the
    readings alone), and each group's gradient cosine at least
    train_first_grad_cos. On the fp32 route the kernels' fp32 instances:
    the bank within fp32_features, the loss within fp32_loss_rel and each
    group's cosine at least fp32_grad_cos. The groups not in ``groups``
    (the text tower and the adapters, which the step does not reach) have
    zero gradients on both routes."""
    import torch

    from clip_for_dl_tpu_torch.train import make_label_fn

    routes = first_step_routes(_build, mods, first, make_label_fn(groups), step32, encode_bank)
    banks = routes["banks"]
    check(torch.equal(banks["kernels"], first["rest"][0]),
          f"{name}: the bank encoded again differs from the command's")
    failures: list = []
    held("the bank's unit text features (B3, B4) against the plain route", banks["kernels"],
         banks["plain"], TOL["eval_text_features"], {"classes": apart(banks["plain"])},
         failures, bound=False)
    held("the fp32 bank (B3 fp32) against the plain fp32 route", banks["kernels_fp32"],
         banks["plain_fp32"], TOL["fp32_features"], {"classes": apart(banks["plain_fp32"])},
         failures, bound=False)
    check(not failures, "; ".join(failures))
    print(f"  in bf16 the plain bank lies "
          f"{float((banks['plain'] - banks['plain_fp32']).abs().max()):.3e} from the fp32 one")
    (loss_k, grads_k), (loss_p, grads_p) = routes["kernels"], routes["plain"]
    (loss_k32, grads_k32), (loss_p32, grads_p32) = routes["kernels_fp32"], routes["plain_fp32"]
    rel, rel32 = abs(loss_k - loss_p) / abs(loss_p), abs(loss_k32 - loss_p32) / abs(loss_p32)
    bound = TOL["train_first_own"].get((name, "loss"), TOL["train_first_loss_rel"])
    print(f"  the first step, dropout 0: loss {loss_k:.6f} with the kernels, {loss_p:.6f} on the "
          f"plain route (rel {rel:.2e}, tol {bound:.0e}); the fp32 route {loss_k32:.6f} / "
          f"{loss_p32:.6f} (rel {rel32:.2e}, tol {TOL['fp32_loss_rel']:.0e})")
    check(rel <= bound, f"{name}: the first step's loss differs from the plain route's")
    check(rel32 <= TOL["fp32_loss_rel"], f"{name}: the fp32 first step's loss differs from the "
                                         "plain fp32 route's")
    compare_groups(f"{name} first step", grads_k, grads_p, groups, TOL["train_first_grad_cos"])
    compare_groups(f"{name} first step in fp32", grads_k32, grads_p32, groups,
                   TOL["fp32_grad_cos"])
    for g in groups:
        print(f"  {g}: 1 - cosine with the plain fp32 gradient "
              f"{1 - cosine(grads_p[g], grads_p32[g]):.3e} on the plain route")


def multiview_groups(preset: str) -> list:
    """The parameter groups the multi-view step reaches."""
    groups = ["image_tower", "image_projector", "view_fusion"]
    return groups + ["multimodal_attention"] if preset == "multimodal_attention" else groups


def prompt_bank_encoder(tok, max_length: int):
    """``encode(model)``: the "prediction" prompt bank as the train command
    encodes it once an epoch (eval mode, no_grad, unit text features)."""
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.zeroshot import prompts_for_family
    from clip_for_dl_tpu_torch.zeroshot.engine import encode_prompt_bank

    prompts = prompts_for_family("prediction", DISEASE_LABELS)

    def encode(model):
        dev = next(model.parameters()).device
        model.eval()
        with torch.no_grad():
            feats = encode_prompt_bank(
                prompts, DISEASE_LABELS, lambda ids, mask: model.encode_text(
                    torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                    normalize=True), tok, max_length)
        return feats.to(dev)

    return encode


def train_first_step_sweep(_build, mods, dev, seeds) -> None:
    """The readings behind phase 11's own bounds (train_first_own): the
    first multi-view step of scripts_train and multimodal_attention at full
    width, B = 32 exams of 224x224 grey noise (two views each, as the
    device cache gives them), 16-label targets, augmentation on, from the
    weights of each seed, each route with its own prompt bank
    (first_step_readings). Beside them, each seed's bank: the kernels' max
    |difference| from the plain route's, the plain bank's from the plain
    fp32 one and the fp32 kernels' from that. Then the extremes over the
    seeds. Checks nothing."""
    import dataclasses

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import get_preset
    from clip_for_dl_tpu_torch.tools.main_paths import tokenizer
    from clip_for_dl_tpu_torch.train import make_label_fn, make_multiview_train_step

    tok = tokenizer()
    label_fn = make_label_fn([])
    for name in ("scripts_train", "multimodal_attention"):
        preset = get_preset(name)
        cfg = dataclasses.replace(preset.model, flash_attention=True, bert_fused_mlp=True)
        aug = preset.augment
        kw = dict(temperature=cfg.temperature, image_size=cfg.image_size, mean=aug.mean,
                  std=aug.std, use_enhance=cfg.use_multimodal_attention, augment=aug.enabled,
                  flip_prob=aug.horizontal_flip_prob, rotation_degrees=aug.rotation_degrees,
                  translate_frac=aug.translate_frac, max_grad_norm=preset.train.max_grad_norm)

        def make(model, opt, seed):
            rng = np.random.default_rng(seed)
            labels = (rng.random((32, 16)) < 0.2).astype(np.float32)
            labels[np.arange(32), rng.integers(0, 16, 32)] = 1.0
            batch = {"images": torch.from_numpy(rng.integers(
                0, 256, (32, 2, 224, 224, 1), dtype=np.uint8)).to(dev),
                "labels": torch.from_numpy(labels).to(dev)}
            return (make_multiview_train_step(model, opt, label_fn, **kw),
                    make_multiview_train_step(model, opt, label_fn, compute_dtype=torch.float32,
                                              **kw),
                    batch, (None, {"default": preset.train.lr}))

        groups = multiview_groups(name)
        rows = first_step_readings(_build, mods, dev, name, cfg, seeds,
                                   preset.train.weight_decay, label_fn, groups, make,
                                   prompt_bank_encoder(tok, cfg.max_text_length))

        def apart_max(a, b):
            return [float((r["banks"][a] - r["banks"][b]).abs().max()) for r in rows]

        bank, rounding = apart_max("kernels", "plain"), apart_max("plain", "plain_fp32")
        bank32 = apart_max("kernels_fp32", "plain_fp32")
        for r, x, y, z in zip(rows, bank, rounding, bank32):
            print(json.dumps({"case": name, "seed": r["seed"], "bank": x, "bank_rounding": y,
                              "bank_fp32": z}))
        print_extremes(name, rows, groups)
        print(f"  bank max |kernels - plain| {max(bank):.3e} (fp32 {max(bank32):.3e}), max "
              f"|plain - plain fp32| {max(rounding):.3e}, min {min(rounding):.3e}, their ratio "
              f"max {max(x / y for x, y in zip(bank, rounding)):.3f}")


def train_phase11(_build, mods, dev, seed: int, card: str, workdir: str,
                  results: dict) -> dict:
    """Phase 11: the scripts' multi-view training in both presets, the
    multimodal zero-shot and the shared-embedding adapter through
    ``cli.main.main(argv)`` on phase 9's layout, vocab, tower files and
    pretrain directory; returns the launches of its paths."""
    import gc
    import importlib
    import io
    import math
    import os
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    steps_module = importlib.import_module("clip_for_dl_tpu_torch.train.steps")
    train_package = importlib.import_module("clip_for_dl_tpu_torch.train")
    engine_module = importlib.import_module("clip_for_dl_tpu_torch.zeroshot.engine")
    driver = importlib.import_module("clip_for_dl_tpu_torch.zeroshot.driver")
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.train import (
        CheckpointManager, TrainState, loop, make_label_fn, make_optimizer,
    )
    from clip_for_dl_tpu_torch.train.checkpoint import model_state
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t_phase = time.perf_counter()
    kaggle, work9, work = f"{workdir}/kaggle", f"{workdir}/cli", f"{workdir}/train"
    os.makedirs(work)
    vocab = f"{work9}/vocab.txt"
    data = ["--reports-csv", f"{work9}/labeled.csv", "--projections-csv",
            f"{kaggle}/indiana_projections.csv", "--image-dir",
            f"{kaggle}/images/images_normalized", "--image-cache", f"{work9}/cache",
            "--vocab", vocab, "--device-cache"]
    kernels = ["--flash-attention", "--bert-fused-mlp"]
    towers = ["--init-image-tower", f"{work9}/image_tower.safetensors", "--init-text-tower",
              f"{work9}/bert.safetensors"]
    tok = BertTokenizer(vocab, do_lower_case=False)
    prompts = prompts_for_family("prediction", DISEASE_LABELS)
    layers = get_preset("scripts_train").model.text_layers
    by_path, walls, failures = {}, {}, []
    def storages():
        """The CUDA storages Python can reach: data pointer -> (bytes, a
        tensor on it)."""
        found = {}
        for o in gc.get_objects():
            try:
                if torch.is_tensor(o) and o.is_cuda:
                    found[o.untyped_storage().data_ptr()] = (o.untyped_storage().nbytes(), o)
            except Exception:  # objects that refuse inspection
                continue
        return found

    def settled():
        """memory_allocated after a collection, with cuBLAS's workspaces (one
        a handle and stream, kept by torch) cleared."""
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    base_mem, base_storages = settled(), set(storages())

    def released(what):
        """What phase 11 still holds on the device after ``what`` above its
        start (settled): nothing of a run may outlive it (its model and
        AdamW state would sit under the next run's peak and rate). Over the
        limit, the largest new storages Python can reach, and who refers to
        them."""
        held_mib = (settled() - base_mem) / 2**20
        new = {k: v for k, v in storages().items() if k not in base_storages}
        seen_mib = sum(n for n, _ in new.values()) / 2**20
        print(f"  after {what}: {held_mib:.1f} MiB allocated above phase 11's start "
              f"({base_mem / 2**30:.2f} GiB), {seen_mib:.1f} MiB of it in {len(new)} storages "
              f"Python reaches")
        if held_mib > TOL["held_mib"]:
            for n, t in sorted(new.values(), key=lambda v: -v[0])[:12]:
                holders = [type(r).__name__ for r in gc.get_referrers(t)
                           if r is not new.get(t.untyped_storage().data_ptr())][:4]
                print(f"    {n / 2**20:.1f} MiB {list(t.shape)} {t.dtype} held by "
                      f"{holders or 'nothing Python sees (an autograd graph?)'}")
        check(held_mib <= TOL["held_mib"], f"{what} left {held_mib:.1f} MiB on the device")

    def run(name, argv, path=None):
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}: {out.getvalue()[-2000:]}")
        if path:
            by_path[path] = dict(_build.LAUNCHES)
            check_launched(mods, by_path[path], path)
        print(f"  {name}: exit 0 in {walls[name]:.1f} s on {card}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
              + (f"; launches {by_path[path]}" if path else ""))
        return out.getvalue()

    # the steps (timed, the first kept), the evaluation batches, the bank
    # encodes and the checkpoint saves of a command
    first, epoch, eval_batches, bank_ms, saves = {}, [], [], [], []
    run_epoch, run_eval = loop.run_epoch, loop.run_eval
    encode_bank, save = engine_module.encode_prompt_bank, CheckpointManager.save

    def timed_epoch(step_fn, state, loader, *a, **kw):
        def timed_step(st, batch, *rest):
            if not first:
                gen = rest[-1] if isinstance(rest[-1], torch.Generator) else None
                first.update(
                    step=step_fn, state=st, rest=rest,
                    batch={k: v.clone() if torch.is_tensor(v) else np.array(v, copy=True)
                           for k, v in batch.items()},
                    weights={k: v.detach().clone() for k, v in st.model.state_dict().items()},
                    optimizer=copy.deepcopy(st.optimizer.state_dict()),
                    generator=None if gen is None else gen.get_state())
            t0 = time.perf_counter()
            out = step_fn(st, batch, *rest)
            torch.cuda.synchronize(dev)
            epoch.append((batch["images"].shape[0], time.perf_counter() - t0))
            return out

        return run_epoch(timed_step, state, loader, *a, **kw)

    def counted_eval(eval_fn, state, loader, *a, **kw):
        def count(batches):
            for b in batches:
                eval_batches.append(b["images"].shape[0])
                yield b
        return run_eval(eval_fn, state, count(loader), *a, **kw)

    def timed_bank(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = encode_bank(*a, **kw)
        torch.cuda.synchronize(dev)
        bank_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_save(self, *a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        save(self, *a, **kw)
        saves.append((time.perf_counter() - t0) * 1e3)

    made, make_real = [], train_package.make_multiview_train_step

    def make_step(*a, **kw):  # the command's step, and what it was built from
        made.append((a, kw))
        return make_real(*a, **kw)

    def instrumented():
        first.clear()
        for kept in (epoch, eval_batches, bank_ms, saves, made):
            kept.clear()
        stack = ExitStack()
        for owner, name, fn in ((loop, "run_epoch", timed_epoch), (loop, "run_eval", counted_eval),
                                (engine_module, "encode_prompt_bank", timed_bank),
                                (CheckpointManager, "save", timed_save),
                                (train_package, "make_multiview_train_step", make_step)):
            stack.enter_context(mock.patch.object(owner, name, fn))
        return stack

    # -- 1, 2. train in both presets ------------------------------------------------------
    train_dirs, bank_kernels = {}, dict.fromkeys(("image_prep", "flash_attention", "mlp"))
    for preset, path in (("scripts_train", "cli_train"),
                         ("multimodal_attention", "cli_train_multimodal")):
        d = train_dirs[preset] = f"{work}/{preset}"
        stack, kept = first_inputs(mods, bank_kernels)
        with instrumented(), stack:
            run(f"train --preset {preset}",
                ["train", "--preset", preset, *data, *kernels, *towers, "--epochs",
                 str(TRAIN_EPOCHS), "--batch-size", "32", "--checkpoint-dir", f"{d}/ck",
                 "--log-dir", f"{d}/logs"], path)
        launches = by_path[path]
        steps = len(epoch)
        exams = [b for b, _ in epoch]
        secs = [t for _, t in epoch]
        b2, b3, b4 = (launches.get(KERNELS[k][0], 0)
                      for k in ("image_prep", "flash_attention", "mlp"))
        chunks = math.ceil(sum(len(v) for v in prompts.values()) / engine_module._PROMPT_BATCH)
        print(f"  {steps} steps of B = {exams[0]} exams ({2 * exams[0]} views), "
              f"{len(eval_batches)} validation batches, {len(bank_ms)} bank encode(s): B2 "
              f"launched {b2} times, B3 {b3}, B4 {b4}")
        check(b2 == steps + len(eval_batches), f"{path}: B2 launched {b2} times for {steps} "
                                               f"steps and {len(eval_batches)} eval batches")
        check(b3 == b4 == layers * chunks * len(bank_ms),
              f"{path}: B3 {b3}, B4 {b4} launches for {len(bank_ms)} bank encodes")
        with open(f"{d}/logs/training_history.csv", newline="") as f:
            history = list(csv.DictReader(f))
        check(len(history) == TRAIN_EPOCHS
              and all(np.isfinite(float(row[k])) for row in history
                      for k in ("train_loss", "val_loss")), f"history {history}")
        rate = sum(exams[1:]) / sum(secs[1:])
        ms = sorted(t * 1e3 for t in secs[1:])
        print(f"train --preset {preset} on {card}: {rate:.1f} exams/s, {2 * rate:.1f} images/s "
              f"over steps 1-{steps - 1} of {TRAIN_EPOCHS} epochs (each synced; the step "
              f"{statistics.median(ms):.1f} ms median, {ms[0]:.1f}-{ms[-1]:.1f}; step 0 "
              f"{secs[0] * 1e3:.1f} ms); the bank encode at "
              f"{get_preset(preset).model.max_text_length} tokens "
              f"{[round(x, 1) for x in bank_ms]} ms; checkpoint save "
              f"{[round(x, 1) for x in saves]} ms; history {history}")
        # the last checkpoint restores bit-equal into a zeroed twin
        state = first["state"]
        twin = copy.deepcopy(state.model)
        with torch.no_grad():
            for p in twin.parameters():
                p.zero_()
        label_fn = make_label_fn([])
        twin_opt = make_optimizer(twin, label_fn,
                                  weight_decay=get_preset(preset).train.weight_decay)
        CheckpointManager(f"{d}/ck").restore(TrainState(twin, twin_opt), TRAIN_EPOCHS - 1)
        check(states_equal(model_state(twin), model_state(state.model))
              and torch_equal(twin_opt.state_dict()["state"],
                              state.optimizer.state_dict()["state"]),
              f"{path}: the checkpoint does not restore the state bit for bit")
        print(f"  the epoch-{TRAIN_EPOCHS - 1} checkpoint restores the weights, BatchNorm "
              f"statistics and AdamW moments bit-equal")
        del twin, twin_opt
        model, opt = state.model, state.optimizer
        split = step_split(
            dev, first, {"prep": (steps_module, "preprocess_images"),
                         "augment": (steps_module, "augment_batch"),
                         "towers": (model, "encode_multiview"),
                         "loss": (steps_module, "_multiview_loss"),
                         "clip": (steps_module, "clip_by_global_norm_"),
                         "optimizer": (opt, "step")},
            {"backward": ("loss", "clip")})[0]  # the outputs would hold the step's graph
        del model, opt
        print(f"  the step in parts, ms (median of 5, synced at each part's bounds; augment is "
              f"the warp): {json.dumps({k: round(v, 3) for k, v in split.items()})}")
        print(f"phase 11, {path}: B2 at the first step's input, B3 and B4 at the bank's first "
              f"inputs, against their plain versions:")
        hold_first_inputs(mods, kept, bank_kernels, path, results)
        print(f"phase 11, {path}: the first step against the plain route, each route with its "
              f"own prompt bank (B2's output shared, the same augmentation draw), and on the "
              f"fp32 route:")
        check(len(made) == 1, f"{path} built {len(made)} multi-view steps")
        (a, kw), = made
        step32 = make_real(*a, **{**kw, "compute_dtype": torch.float32})
        multiview_first_step(_build, mods, first, multiview_groups(preset),
                             prompt_bank_encoder(tok, get_preset(preset).model.max_text_length),
                             step32, preset)
        first.clear()
        kept.clear()
        made.clear()
        del state, step32, a, kw
        released(f"train --preset {preset}")

    # -- 3. zeroshot --preset multimodal_attention --dynamic, and on the plain route ---------
    def recorded():
        """Each view's logits as the engine dispatches them (both passes),
        and the weighted view-max probabilities [exams, 16] of the second
        pass, the rows the command's CSV holds, as merge_views_weighted
        thresholds them."""
        got = {"logits": [], "weighted": [], "mask": None}
        dispatch, merge, mask_of = ZeroShotEngine._dispatch, driver.merge_views_weighted, \
            driver._mask_of

        def record_dispatch(self, images):
            out, n = dispatch(self, images)
            got["logits"].append(out[:n].float().clone())
            return out, n

        def record_mask(batch):
            got["mask"] = mask_of(batch)
            return got["mask"]

        def record_merge(view_probs, disease_list, thresholds, frontal, lateral):
            w = (np.asarray(view_probs) * np.array([frontal, lateral])[None, :, None]).max(1)
            got["weighted"].append(w if got["mask"] is None else w[got["mask"]])
            return merge(view_probs, disease_list, thresholds, frontal, lateral)

        stack = ExitStack()
        for owner, name, fn in ((ZeroShotEngine, "_dispatch", record_dispatch),
                                (driver, "_mask_of", record_mask),
                                (driver, "merge_views_weighted", record_merge)):
            stack.enter_context(mock.patch.object(owner, name, fn))
        return stack, got

    def outputs(log):
        """The command's thresholds [16] and prediction sets [exams, 16]."""
        with open(f"{log}/thresholds.json") as f:
            thresholds = json.load(f)
        with open(f"{log}/zero_shot_results.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        check(sorted(thresholds) == sorted(DISEASE_LABELS), f"thresholds.json {thresholds}")
        sets = [set(r["predictions"].split("; ")) for r in rows]
        return (np.array([thresholds[d] for d in DISEASE_LABELS]),
                np.array([[d in p for d in DISEASE_LABELS] for p in sets]))

    zs = ["zeroshot", "--preset", "multimodal_attention", *data, *kernels, "--dynamic",
          "--checkpoint", f"{train_dirs['multimodal_attention']}/ck"]
    zs_kernels = dict.fromkeys(("similarity", "image_prep"))
    stack, kept = first_inputs(mods, zs_kernels)
    record, rec_k = recorded()
    with record, stack:
        out = run("zeroshot --preset multimodal_attention --dynamic",
                  [*zs, "--log-dir", f"{work}/zs"], "cli_zeroshot_multimodal")
    record, rec_p = recorded()
    with record, plain_kernels(mods):
        run("zeroshot --preset multimodal_attention --dynamic, plain route",
            [*zs, "--log-dir", f"{work}/zs_plain"])
        check(not _build.LAUNCHES, f"a kernel ran during the plain run: {_build.LAUNCHES}")
    print("phase 11, zeroshot --preset multimodal_attention: B1 on the enhance path and B2 at "
          "the command's first inputs, against their plain versions:")
    hold_first_inputs(mods, kept, zs_kernels, "the multimodal zeroshot", results)
    probs_k, probs_p = (torch.sigmoid(torch.cat(r["logits"])).cpu().numpy()
                        for r in (rec_k, rec_p))
    held("the multimodal zero-shot's probabilities (B1-B4, enhance), every view", probs_k,
         probs_p, TOL["probs_vs_plain"], {"views": apart(probs_p)}, failures, bound=False)
    check(not failures, "; ".join(failures))
    # The predictions each run made under its own calibrated thresholds.
    # The probabilities agree within probs_vs_plain, so where the plain
    # weighted probability lies further than that above both runs'
    # thresholds, the class clears them in both runs and is in both sets.
    # Where it lies further than that below both, the class clears neither,
    # and the argmax fallback cannot take it in either run where the exam's
    # top weighted probability lies more than twice that above it: in
    # neither set. In an exam where every class lies below both, the
    # fallback takes the top class in both runs where the next lies more
    # than twice that below it. Those decided (exam, class) pairs must
    # agree. (A model whose probabilities in an exam all lie within twice
    # the tolerance of each other, below the thresholds, decides no pair:
    # then the sets carry nothing beyond the probability bound, and the
    # count says so.)
    (t_k, sets_k), (t_p, sets_p) = outputs(f"{work}/zs"), outputs(f"{work}/zs_plain")
    w_p = np.concatenate(rec_p["weighted"])
    check(w_p.shape == sets_p.shape == sets_k.shape,
          f"{w_p.shape} weighted rows, {sets_p.shape} and {sets_k.shape} prediction sets")
    tol = TOL["probs_vs_plain"]
    above, below = w_p - np.maximum(t_k, t_p) > tol, np.minimum(t_k, t_p) - w_p > tol
    top = np.sort(w_p, axis=1)
    fallback = (below.all(1, keepdims=True) & (top[:, -1:] - top[:, -2:-1] > 2 * tol)
                & (w_p == top[:, -1:]))
    decided = above | (below & (top[:, -1:] - w_p > 2 * tol)) | fallback
    differ = sets_k != sets_p
    print(f"  the prediction sets of both runs under their thresholds.json (thresholds differ "
          f"by up to {float(np.abs(t_k - t_p).max()):.3e}): {int(decided.sum())} of "
          f"{decided.size} (exam, class) pairs decided ({int(above.sum())} above both "
          f"thresholds by more than {tol:.0e}, {int(fallback.sum())} decided fallbacks, the "
          f"rest absent in both), {int(differ[decided].sum())} of them differ; "
          f"{int(differ[~decided].sum())} of the other {int((~decided).sum())} differ")
    print(f"  an exam's weighted probabilities span {float(np.median(top[:, -1] - top[:, 0])):.3e}"
          f" (median); {int(below.all(1).sum())} of {len(w_p)} exams lie below both thresholds "
          f"in every class and take the argmax fallback, decided where the top two lie more "
          f"than {2 * tol:.0e} apart")
    check(not differ[decided].any(), "the multimodal zero-shot's decided predictions differ "
                                     "from the plain route's")
    metrics = json.loads(out[out.rindex("\n{\n") + 1:]) if "\n{\n" in out else {}
    print(f"  metrics {json.dumps({k: metrics[k] for k in sorted(metrics)[:6]})}")

    # -- 4. shared-adapter from phase 9's pretrain directory -------------------------------------
    sa, reports_kernels = f"{work}/shared", dict.fromkeys(("flash_attention", "mlp"))
    stack, kept = first_inputs(mods, reports_kernels)
    with instrumented(), stack:
        out = run("shared-adapter", ["shared-adapter", *data, *kernels, "--epochs", "1",
                                     "--batch-size", "16", "--checkpoint", f"{work9}/pretrain",
                                     "--checkpoint-dir", f"{sa}/ck", "--log-dir", f"{sa}/logs"],
                  "cli_shared_adapter")
    exams = [b for b, _ in epoch]
    secs = [t for _, t in epoch]
    k = min(1, len(secs) - 1)
    with open(f"{sa}/logs/shared_adapter_metrics.json") as f:
        metrics = json.load(f)
    # a class without positives in the validation split has no AUROC of its own
    check(all(np.isfinite(v) for k_, v in metrics.items() if not k_.startswith("auroc/")),
          f"non-finite shared-adapter metrics {metrics}")
    best = CheckpointManager(f"{work9}/pretrain").best_epoch()
    before = torch.load(f"{work9}/pretrain/{best}.pt", map_location="cpu",
                        weights_only=True)["model"]
    after = torch.load(f"{sa}/ck/0.pt", map_location="cpu", weights_only=True)["model"]
    moved = sorted(k_ for k_, v in after.items() if not torch.equal(v, before[k_]))
    check(moved == ["shared_adapter.classifier.bias", "shared_adapter.classifier.weight"],
          f"shared-adapter moved {moved[:8]}")
    ms = sorted(t * 1e3 for t in secs[k:])
    print(f"shared-adapter on {card}: {sum(exams[k:]) / sum(secs[k:]):.1f} exams/s over steps "
          f"{k}-{len(secs) - 1} of B = {exams[0]} (each synced; the step "
          f"{statistics.median(ms):.1f} ms median, {ms[0]:.1f}-{ms[-1]:.1f}; the reports through "
          f"BERT every step; step 0 {secs[0] * 1e3:.1f} ms); checkpoint save "
          f"{[round(x, 1) for x in saves]} ms; only the shared adapter moved; macro AUROC "
          f"{metrics.get('auroc_macro')}, mAP {metrics.get('mAP')}")
    print("phase 11, shared-adapter: B3 and B4 at the reports' first inputs against their "
          "plain versions:")
    hold_first_inputs(mods, kept, reports_kernels, "shared-adapter", results)
    kept.clear()
    first.clear()
    released("shared-adapter")
    print(f"phase 11 on {card}: command wall times "
          f"{json.dumps({k_: round(v, 2) for k_, v in walls.items()})} s")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return by_path



VIT_TRAIN_STEPS = 11  # phase 12's timed ViT train steps at B = 128 (the first not counted)


def vit_train_step(_build, mods, dev, seed: int, card: str) -> dict:
    """Phase 12, part 1: the ``vit`` preset's train step at B = 128 (ViT-B/16
    and BERT-base, 200 tokens, bf16, flash attention, the fused BERT MLP and
    vit_fused_mlp_train, dropout 0), with the exact and with the tanh GELU
    in the ViT's MLPs: from the same weights, one step with the kernels
    against one with their plain versions (B2 kept, as in phase 4; the loss
    within train_loss_rel, each group's gradient cosine at least
    grad_cos), then VIT_TRAIN_STEPS synced steps, counted. Returns the
    launches of the vit_train and vit_train_tanh paths."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    t0 = time.perf_counter()
    preset, cfg, model = train_model(dev, seed, "vit", vit_fused_mlp_train=True)
    groups = [g.name for g in preset.train.groups]
    label_fn, lrs = make_label_fn(groups), base_lrs(preset)
    batch = train_batch(np.random.default_rng(seed + 12), tokenizer(), dev, TRAIN_BATCH,
                        TRAIN_LEN)
    print(f"model: {describe(cfg)}, training MLP in the ViT; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M fp32 master parameters, "
          f"bf16 compute, dropout 0; built in {time.perf_counter() - t0:.1f} s; batch "
          f"{TRAIN_BATCH} x 512x512 grey uint8 at {cfg.image_size}, {TRAIN_LEN}-token reports")
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    layers = list(model.image_tower.encoder.layers)

    def fresh():
        model.load_state_dict(init)
        opt, step = pretrain_step(model, preset, cfg)
        return TrainState(model, opt), step

    def one_step():
        state, step = fresh()
        loss = float(step(state, batch, lrs)[1]["loss"])
        return loss, group_grads(model, label_fn)

    by_path = {}
    for path, approximate in (("vit_train", False), ("vit_train_tanh", True)):
        for layer in layers:
            layer.gelu_approximate = approximate
        print(f"the ViT's GELU: {'tanh' if approximate else 'exact erf'}")
        cudnn = torch.backends.cudnn
        flags = (cudnn.deterministic, cudnn.benchmark)
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            loss_k, grads_k = one_step()
            with plain_kernels(mods, keep=("image_prep",)):
                before = dict(_build.LAUNCHES)
                loss_p, grads_p = one_step()
                check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                          if k != mods["image_prep"].KERNEL),
                      "a kernel other than B2 ran during the plain ViT step")
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        print(f"  one step: loss {loss_k:.6f} with the kernels, {loss_p:.6f} with the plain "
              f"versions (rel {loss_err:.2e}, tol {TOL['train_loss_rel']:.0e})")
        check(loss_err <= TOL["train_loss_rel"], "the ViT step's loss differs from the plain "
                                                 "step's")
        compare_groups("the ViT step", grads_k, grads_p, groups, TOL["grad_cos"])
        del grads_k, grads_p
        state, step = fresh()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        times, losses = [], []
        for _ in range(VIT_TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(float(step(state, batch, lrs)[1]["loss"]))  # syncs the step
            times.append(time.perf_counter() - t)
        by_path[path] = dict(_build.LAUNCHES)
        steady = times[1:]
        print(f"  {path} on {card}: {TRAIN_BATCH * len(steady) / sum(steady):.1f} samples/s "
              f"over steps 1-{VIT_TRAIN_STEPS - 1} ({1e3 * statistics.median(steady):.1f} ms "
              f"median, {1e3 * min(steady):.1f}-{1e3 * max(steady):.1f}; step 0 "
              f"{times[0] * 1e3:.1f} ms); peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {by_path[path]}")
        # at random init the preset's projector rate (1e-3) makes the loss
        # on one fixed batch jump after the first Adam step: finite is the
        # check, the step against the plain route the numerics'
        check(all(np.isfinite(losses)), f"the ViT steps' losses {losses}")
        check_launched(mods, by_path[path], path)
    return by_path


def vit_lora_phase12(_build, mods, dev, seed: int, card: str, workdir: str,
                     results: dict) -> dict:
    """Phase 12: ViT training and LoRA (ROADMAP A8). Part 1 is
    vit_train_step; part 2 runs ``cli.main.main(argv)`` on phase 9's
    layout, vocab, BERT file and pretrain directory: ``pretrain --preset
    vit --fast-gelu --flash-attention --bert-fused-mlp --vit-fused-mlp-train``
    (two epochs), ``pretrain --lora 8`` from phase 9's pretrain directory
    (ResNet-50: the text tower and the heads adapted), ``pretrain --preset
    vit --lora 8 --fused-mlp --flash-attention`` from the ViT run's
    directory, and ``zeroshot --checkpoint <dir>/folded`` for each LoRA run.
    Holds the kernels of each training run at their first inputs against
    their plain versions (the ViT run's B4 and B8 in the tanh form), each
    run's first step against the plain route (phase 4's bounds; in a LoRA
    run a group below them only where the fp32 route bears the departure
    out, lora_first_step) and each folded model against the merged one (the frozen
    weights with the trained factors merged inside the forward, as the LoRA
    steps run it): features and zero-shot probabilities. Prints each
    command's wall time, samples/s over its steps after the first (each
    synced), peak memory and what it leaves on the device (at most
    held_mib). Returns the launches of its paths."""
    import gc
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    lora_module = importlib.import_module("clip_for_dl_tpu_torch.models.lora")
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.inference import load_trained_model
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.train import loop
    from clip_for_dl_tpu_torch.train.checkpoint import load_model, model_state
    from clip_for_dl_tpu_torch.zeroshot import prompts_for_family

    t_phase = time.perf_counter()
    by_path = vit_train_step(_build, mods, dev, seed, card)
    print(f"  part 1 took {time.perf_counter() - t_phase:.1f} s")

    def settled():
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    base_mem = settled()
    kaggle, work9, work = f"{workdir}/kaggle", f"{workdir}/cli", f"{workdir}/vit_lora"
    os.makedirs(work)
    vocab = f"{work9}/vocab.txt"
    data = ["--reports-csv", f"{work9}/labeled.csv", "--projections-csv",
            f"{kaggle}/indiana_projections.csv", "--image-dir",
            f"{kaggle}/images/images_normalized", "--image-cache", f"{work9}/cache",
            "--vocab", vocab, "--device-cache"]
    walls, steps, first, kept = {}, [], {}, {}
    run_epoch, make_lora = loop.run_epoch, lora_module.make_lora_pretrain_step

    def timed_epoch(step_fn, state, loader, *a, **kw):
        def timed_step(st, batch, *rest):
            if not first:
                gen = rest[-1] if isinstance(rest[-1], torch.Generator) else None
                first.update(
                    step=step_fn, state=st, rest=rest,
                    batch={k: v.clone() if torch.is_tensor(v) else np.array(v, copy=True)
                           for k, v in batch.items()},
                    weights={k: v.detach().clone() for k, v in st.model.state_dict().items()},
                    optimizer=copy.deepcopy(st.optimizer.state_dict()),
                    generator=None if gen is None else gen.get_state())
            t0 = time.perf_counter()
            out = step_fn(st, batch, *rest)
            torch.cuda.synchronize(dev)
            steps.append((batch["images"].shape[0], time.perf_counter() - t0))
            return out

        return run_epoch(timed_step, state, loader, *a, **kw)

    def keep_lora(model, lora, *a, **kw):  # the frozen model and the factors it trains
        kept.update(model=model, lora=lora, alpha=kw["alpha"],
                    frozen={k: v.clone() for k, v in model_state(model).items()},
                    step32=make_lora(model, lora, *a, **dict(kw, compute_dtype=torch.float32)))
        return make_lora(model, lora, *a, **kw)

    def run(name, argv, path, groups=None, folded=None, hold=()):
        """One command in this process, its launches counted under ``path``;
        the kernels named in ``hold`` (names, or a dict of first_inputs'
        predicates) held at their first inputs against their plain
        versions; with ``folded``, folded_against_merged(*folded)
        (before the first step's check, which runs a step on the command's
        factors); with ``groups``, its first step held against the plain
        route."""
        first.clear()
        steps.clear()
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        which = hold if isinstance(hold, dict) else dict.fromkeys(hold)
        inputs_kept, inputs = first_inputs(mods, which)
        t0 = time.perf_counter()
        with mock.patch.object(loop, "run_epoch", timed_epoch), \
                mock.patch.object(lora_module, "make_lora_pretrain_step", keep_lora), \
                inputs_kept, redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}: {out.getvalue()[-2000:]}")
        by_path[path] = dict(_build.LAUNCHES)
        check_launched(mods, by_path[path], path)
        rate = ""
        if len(steps) > 1:
            n, s = sum(b for b, _ in steps[1:]), sum(t for _, t in steps[1:])
            rate = (f", {n / s:.1f} samples/s over {len(steps) - 1} steps after the first "
                    f"(B = {steps[0][0]}; step 0 {steps[0][1] * 1e3:.1f} ms)")
        print(f"  {name}: exit 0 in {walls[name]:.1f} s on {card}{rate}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches "
              f"{by_path[path]}")
        if hold:
            hold_first_inputs(mods, inputs, which, name, results)
        del inputs
        if folded is not None:
            model, step32 = kept["model"], kept.pop("step32")
            folded_against_merged(*folded)
            lora_first_step(_build, mods, first, groups, model, step32)
        elif groups is not None:
            step_against_plain(_build, mods, first, groups)
        first.clear()
        return out.getvalue()

    def released(what):
        held = (settled() - base_mem) / 2**20
        print(f"  after {what}: {held:.1f} MiB held on the device above phase 12's start")
        check(held <= TOL["held_mib"], f"{what} left {held:.1f} MiB on the device")

    vit_groups = [g.name for g in get_preset("vit").train.groups]
    base_groups = [g.name for g in get_preset("pretrain_clip").train.groups]
    tok = BertTokenizer(vocab, do_lower_case=False)
    prompts = tok.encode([p for ps in prompts_for_family("basic", DISEASE_LABELS).values()
                          for p in ps], max_length=200)

    def folded_against_merged(name, preset, *flags):
        """The folded model from ``<dir>/folded`` (as zeroshot loads it)
        against the merged one, on 32 grey images and the basic prompts:
        image and text features, and the zero-shot probabilities
        sigmoid(similarity / T)."""
        from clip_for_dl_tpu_torch.tools.main_paths import grey_images

        model, lora = kept.pop("model"), kept.pop("lora")
        load_model(model, kept.pop("frozen"))  # the command folded it in place at its end
        cfg = cli._apply_tiny(get_preset(preset), cli.build_parser().parse_args(
            ["zeroshot", *flags]), len(tok.vocab))
        folded = load_trained_model(f"{work}/{name}/folded", cfg, torch.bfloat16, device=dev)
        size = cfg.model.image_size
        images = mods["image_prep"].preprocess_images(
            torch.from_numpy(grey_images(np.random.default_rng(seed + 13), 32)).to(dev), size,
            size, cfg.augment.mean, cfg.augment.std)
        args = (images, torch.from_numpy(prompts["input_ids"]).to(dev),
                torch.from_numpy(prompts["attention_mask"]).to(dev))
        with torch.no_grad():
            merged = lora_module._merged_call(model.eval(), lora, kept.pop("alpha"))(*args)
            got = folded(*args)
        sim = mods["similarity"]
        probs = [torch.sigmoid(sim.similarity(i.float(), t.float(), cfg.model.temperature))
                 for i, t in (got, merged)]
        for what, a_, b_ in (("image features", got[0], merged[0]),
                             ("text features", got[1], merged[1]),
                             ("probabilities", *probs)):
            diff = float((a_.float() - b_.float()).abs().max())
            print(f"  {name}: folded vs merged {what} {list(a_.shape)}: max |difference| "
                  f"{diff:.3e}, bit-equal {torch.equal(a_, b_)}")
            check(torch.equal(a_, b_), f"{name}: the folded model's {what} differ from the "
                                       "merged model's")
        del lora, folded, merged, got

    def tanh(args, kwargs):  # the ViT's B4 and B8 calls: the tanh form
        return bool(args[5:6] and args[5])

    print("part 2: the command line on phase 9's layout")
    vit_flags = ["--preset", "vit", "--flash-attention"]
    run("pretrain --preset vit --vit-fused-mlp-train --fast-gelu",
        ["pretrain", *data, *vit_flags, "--fast-gelu", "--bert-fused-mlp",
         "--vit-fused-mlp-train", "--epochs", "2", "--init-text-tower",
         f"{work9}/bert.safetensors", "--checkpoint-dir", f"{work}/vit",
         "--log-dir", f"{work}/logs_vit"], "cli_pretrain_vit", vit_groups,
        hold={"mlp": tanh, "mlp_bwd": tanh})
    released("pretrain --preset vit")
    run("pretrain --lora 8", ["pretrain", *data, "--flash-attention", "--bert-fused-mlp",
                              "--lora", "8", "--epochs", "1", "--checkpoint",
                              f"{work9}/pretrain", "--checkpoint-dir", f"{work}/lora",
                              "--log-dir", f"{work}/logs_lora"], "cli_pretrain_lora",
        base_groups, ("lora", "zero_shot", "--flash-attention", "--bert-fused-mlp"),
        ("flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd"))
    released("pretrain --lora 8")
    run("pretrain --preset vit --lora 8 --fused-mlp",
        ["pretrain", *data, *vit_flags, "--fused-mlp", "--lora", "8", "--epochs", "1",
         "--checkpoint", f"{work}/vit", "--checkpoint-dir", f"{work}/vit_lora",
         "--log-dir", f"{work}/logs_vit_lora"], "cli_pretrain_vit_lora", vit_groups,
        ("vit_lora", "vit", "--fused-mlp", "--flash-attention"),
        ("flash_attention", "flash_attention_bwd", "mlp_block"))
    released("pretrain --preset vit --lora 8")
    run("zeroshot --checkpoint lora/folded",
        ["zeroshot", *data, "--flash-attention", "--bert-fused-mlp", "--checkpoint",
         f"{work}/lora/folded", "--log-dir", f"{work}/zs_lora"], "cli_zeroshot_lora")
    run("zeroshot --preset vit --checkpoint vit_lora/folded",
        ["zeroshot", *data, *vit_flags, "--fused-mlp", "--checkpoint",
         f"{work}/vit_lora/folded", "--log-dir", f"{work}/zs_vit_lora"],
        "cli_zeroshot_vit_lora")
    released("the zero-shot runs")
    print(f"phase 12 on {card}: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


GRADCAM_VIEWS = 512  # the side of phase 13's two grey views


def gradcam_routes(mods, model, model32, views, text, prep_args, faults=False) -> dict:
    """Phase 13's readings of ``interpret.gradcam`` with B2 against its plain
    version, from one bank ``text``, on ``model`` (bf16) and ``model32``,
    its fp32 twin: "b2", B2 at gradcam's input against its plain version;
    and pairs (scores' max |difference| over the largest score, CAMs' max
    |difference|): "bf16", the kernels against the bf16 route with B2
    plain; "kernels" and "plain", the bf16 kernels and the plain bf16
    route, each against the fp32 route with B2 plain; "fp32", B2 against
    its plain version on the fp32 twin. With ``faults``, also planted faults
    of B2 on the bf16 kernel route, name -> (B2's output from the right
    one, max |difference|; the pair against the fp32 route): "std", each
    channel's std one bf16 step (2^-7) too large; "row", the resize one
    source row off (the views rolled down by one row)."""
    import torch

    from clip_for_dl_tpu_torch.interpret import gradcam

    prep = mods["image_prep"]
    x = prep.preprocess_images(views, *prep_args)
    b2 = float((x - prep.preprocess_reference(views, *prep_args)).abs().max())
    # plain_kernels' keep: every kernel module but B2's
    with plain_kernels(mods, keep=("similarity", "flash_attention", "mlp_train", "mlp_block")):
        plain_b2 = prep.preprocess_images(views, *prep_args)
        bf16_p, fp32_p = gradcam(model, plain_b2, text), gradcam(model32, plain_b2, text)
    bf16_k, fp32_k = gradcam(model, x, text), gradcam(model32, x, text)

    def pair(a, b):
        (cams_a, scores_a), (cams_b, scores_b) = a, b
        return (float((scores_a - scores_b).abs().max() / scores_b.abs().max()),
                float((cams_a - cams_b).abs().max()))

    out = {"b2": b2, "bf16": pair(bf16_k, bf16_p), "kernels": pair(bf16_k, fp32_p),
           "plain": pair(bf16_p, fp32_p), "fp32": pair(fp32_k, fp32_p)}
    if faults:
        size_h, size_w, mean, std, dtype = prep_args
        planted = {"std": (views, (size_h, size_w, mean, [v * (1 + 2 ** -7) for v in std],
                                   dtype)),
                   "row": (torch.roll(views, 1, dims=1), prep_args)}
        for name, (v, a) in planted.items():
            xf = prep.preprocess_images(v, *a)
            out[name] = (float((xf - x).abs().max()), pair(gradcam(model, xf, text), fp32_p))
    return out


def gradcam_sweep(_build, mods, dev, seeds) -> None:
    """The readings behind phase 13's gradcam bounds (cam_bf16_scores_rel,
    cam_bf16_abs, cam_fp32_scores_rel): gradcam_routes on the weights and views of each
    seed, as phase 13 draws them. Prints; checks nothing."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import prompts_for_family

    print(f"gradcam readings on {card_line()}")
    rows = []
    for seed in seeds:
        cfg, engine = build_engine(dev, seed, "serve")
        _, engine32 = build_engine(dev, seed, "serve_fp32")
        views = torch.from_numpy(grey_images(np.random.default_rng(seed + 17), 2,
                                             GRADCAM_VIEWS)).to(dev)
        text = engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
        size = cfg.image_size
        r = gradcam_routes(mods, engine.model, engine32.model, views, text,
                           (size, size, engine.mean, engine.std, torch.float32), faults=True)
        ratios = tuple(k / p for k, p in zip(r["kernels"], r["plain"]))
        rows.append(r)
        print(f"  seed {seed}: B2 {r['b2']:.3e}; scores, CAMs: bf16 B2 plain {r['bf16'][0]:.3e}, "
              f"{r['bf16'][1]:.3e}; from fp32: kernels {r['kernels'][0]:.3e}, "
              f"{r['kernels'][1]:.3e}, plain bf16 {r['plain'][0]:.3e}, {r['plain'][1]:.3e} "
              f"(ratios {ratios[0]:.2f}, {ratios[1]:.2f}); fp32 B2 plain {r['fp32'][0]:.3e}, "
              f"{r['fp32'][1]:.3e}")
        for name in ("std", "row"):
            b2_off, (sc, cam) = r[name]
            print(f"    planted B2 fault {name}: B2's output {b2_off:.3e} from the right one "
                  f"(guard {TOL['image_prep_f32']}); from fp32: scores {sc:.3e} (bound "
                  f"{TOL['cam_bf16_scores_rel']}), CAMs {cam:.3e} (bound {TOL['cam_bf16_abs']})")
        del engine, engine32
    for key in ("kernels", "plain", "fp32"):
        print(f"  {key}: scores {min(r[key][0] for r in rows):.3e} to "
              f"{max(r[key][0] for r in rows):.3e}, CAMs {min(r[key][1] for r in rows):.3e} "
              f"to {max(r[key][1] for r in rows):.3e}")


def interpret_phase13(_build, mods, dev, seed: int, card: str, workdir: str,
                      results: dict) -> dict:
    """Phase 13: Grad-CAM and attention rollout (ROADMAP A9). The library
    half runs ``interpret.gradcam`` on the zero_shot model and
    ``interpret.vit_rollout`` on the vit model (bf16, the kernels on), each
    on two GRADCAM_VIEWS grey views prepared to fp32 by B2, against its
    plain route; the command half runs ``gradcam`` and ``rollout`` with
    --synthetic at full width, their drawing replaced by a recorder where
    matplotlib is missing (and that printed). On every path each kernel is
    also held at its first inputs against its plain version
    (hold_first_inputs, phase-2 tolerances): the end-to-end bounds below
    are witnesses of the whole path, not the kernels' guard. Returns the
    launches of its paths."""
    import importlib
    import importlib.util
    import io
    import os
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.data import SyntheticMultiViewDataset
    from clip_for_dl_tpu_torch.interpret import gradcam, vit_rollout
    from clip_for_dl_tpu_torch.interpret.gradcam import _class_grads, _head_scores
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import prompts_for_family

    t_phase = time.perf_counter()
    prep, by_path, walls = mods["image_prep"], {}, {}
    views = torch.from_numpy(grey_images(np.random.default_rng(seed + 17), 2,
                                         GRADCAM_VIEWS)).to(dev)
    prompts = prompts_for_family("prediction", DISEASE_LABELS)

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        return out

    # Grad-CAM, the library calls; the zero_shot model's fp32 twin (the same
    # seeded weights) is the witness of the bf16 route's own rounding
    cfg, engine = build_engine(dev, seed, "serve")
    _, engine32 = build_engine(dev, seed, "serve_fp32")
    model, model32, size = engine.model, engine32.model, cfg.image_size
    prep_args = (size, size, engine.mean, engine.std, torch.float32)

    def prepared():
        return prep.preprocess_images(views, *prep_args)

    bank_kernels = dict.fromkeys(("image_prep", "flash_attention", "mlp"))
    stack, gradcam_in = first_inputs(mods, bank_kernels)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    with stack:
        text = timed("bank", lambda: engine.build_text_features(prompts))
        x = prepared()
        cams, scores = timed("gradcam", lambda: gradcam(model, x, text))
    by_path["gradcam"] = dict(_build.LAUNCHES)
    check_launched(mods, by_path["gradcam"], "gradcam")
    timed("gradcam, second call", lambda: gradcam(model, prepared(), text))
    check(cams.shape == (16, 2, size // 32, size // 32) and scores.shape == (2, 16),
          f"gradcam gave {list(cams.shape)}, {list(scores.shape)}")
    check(bool(torch.isfinite(cams).all()) and float(cams.min()) >= 0.0
          and float(cams.max()) <= 1.0 + 1e-6, "gradcam's CAMs are not finite in [0, 1]")
    r = gradcam_routes(mods, model, model32, views, text, prep_args)
    with plain_kernels(mods):
        text_p = engine.build_text_features(prompts)
    with torch.no_grad():
        _, stage4 = model.image_tower(x, capture_stage4=True)
    batched, _ = _class_grads(model, stage4.float(), text, 1.0, "similarity")
    s4 = stage4.float().requires_grad_(True)
    looped = torch.stack([torch.autograd.grad(
        _head_scores(model, s4, text, 1.0, "similarity")[:, c].sum(), s4)[0]
        for c in range(16)])

    bank_diff = float((text - text_p).abs().max())
    b2_diff, kernels, plain, fp32 = r["b2"], r["kernels"], r["plain"], r["fp32"]
    bf16_tol = TOL["cam_bf16_scores_rel"], TOL["cam_bf16_abs"]
    print(f"  gradcam on {card}: ResNet-50 bf16, views {list(views.shape)} -> fp32 "
          f"[2, {size}, {size}, 3], CAMs {list(cams.shape)}; B2 at its input "
          f"{b2_diff:.3e} from its plain version (tol {TOL['image_prep_f32']}); the batched "
          f"backward bit-equal to 16 single ones: {torch.equal(batched, looped)}; the bank "
          f"against the plain route {bank_diff:.3e} (tol {TOL['eval_text_features']})")
    print(f"    scores (max |difference| over the largest) and CAMs (max |difference|): bf16, "
          f"B2 against its plain version {r['bf16'][0]:.3e}, {r['bf16'][1]:.3e}; from the "
          f"fp32 route with B2 plain: the kernels {kernels[0]:.3e}, {kernels[1]:.3e} (tol "
          f"{bf16_tol[0]}, {bf16_tol[1]}), the plain bf16 route {plain[0]:.3e}, "
          f"{plain[1]:.3e}; fp32, B2 against its plain version {fp32[0]:.3e} (tol "
          f"{TOL['cam_fp32_scores_rel']}), {fp32[1]:.3e}")
    print(f"    bank {walls['bank'] * 1e3:.1f} ms, gradcam {walls['gradcam'] * 1e3:.1f} / "
          f"{walls['gradcam, second call'] * 1e3:.1f} ms (first / second call); launches "
          f"{by_path['gradcam']}")
    check(b2_diff <= TOL["image_prep_f32"], f"B2 at gradcam's input differs by {b2_diff:.3e}")
    check(torch.equal(batched, looped), "the batched backward differs from single ones")
    check(bank_diff <= TOL["eval_text_features"], f"the bank differs by {bank_diff:.3e}")
    check(fp32[0] <= TOL["cam_fp32_scores_rel"],
          f"fp32 gradcam scores differ by {fp32[0]:.3e} of the largest")
    for what, k, tol in zip(("scores", "CAMs"), kernels, bf16_tol):
        check(k <= tol, f"the bf16 gradcam {what} lie {k:.3e} from the fp32 route")
    hold_first_inputs(mods, gradcam_in, bank_kernels, "gradcam", results)
    del cfg, engine, engine32, model, model32, text, text_p, stage4, s4, batched, looped
    del gradcam_in

    # rollout, the library calls
    cfg, engine = build_engine(dev, seed, "serve_vit")
    tower, size = engine.model.image_tower, cfg.image_size
    check(cfg.flash_attention and cfg.vit_fused_mlp, "the vit model runs without its kernels")
    vit_kernels = dict.fromkeys(("image_prep", "mlp_block"))
    stack, rollout_in = first_inputs(mods, vit_kernels)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    with stack:
        mask = timed("rollout", lambda: vit_rollout(tower, prepared()))
    by_path["rollout"] = dict(_build.LAUNCHES)
    check_launched(mods, by_path["rollout"], "rollout")
    b3 = by_path["rollout"].get(KERNELS["flash_attention"][0], 0)
    check(b3 == 0, f"the rollout launched B3 {b3} times")
    timed("rollout, second call", lambda: vit_rollout(tower, prepared()))
    with plain_kernels(mods):
        mask_p = vit_rollout(tower, prepared())
    g = size // cfg.vit_patch
    check(mask.shape == (2, g, g) and bool(torch.isfinite(mask).all()),
          f"the rollout mask is {list(mask.shape)} or not finite")
    mask_diff = float((mask - mask_p).abs().max())
    mask_cos = float(torch.nn.functional.cosine_similarity(mask.flatten(), mask_p.flatten(),
                                                           dim=0))
    x = prepared()
    with torch.no_grad():
        feats, attns = tower(x, sow_weights=True)
        layers = list(tower.encoder.layers)
        for layer in layers:
            layer.self_attention.flash = False
        try:
            plain_feats = tower(x)
        finally:
            for layer in layers:
                layer.self_attention.flash = True
        discard = vit_rollout(tower, x, "mean", 0.1)
    bit_equal = torch.equal(feats, plain_feats)
    print(f"  rollout on {card}: ViT-B/16 bf16 --fused-mlp, {len(attns)} layers of "
          f"{list(attns[0].shape)} probabilities, mask {list(mask.shape)}: against the plain "
          f"route max |difference| {mask_diff:.3e} (tol {TOL['rollout']}), cosine "
          f"{mask_cos:.6f} (tol {TOL['rollout_cos']}); sowing features bit-equal to flash "
          f"off: {bit_equal}; "
          f"rollout {walls['rollout'] * 1e3:.1f} / {walls['rollout, second call'] * 1e3:.1f} "
          f"ms (first / second call); launches {by_path['rollout']}")
    check(mask_diff <= TOL["rollout"] and mask_cos >= TOL["rollout_cos"],
          f"the rollout mask differs by {mask_diff:.3e}, cosine {mask_cos:.6f}")
    check(bit_equal, "the sowing forward's features differ from the forward with flash off")
    check(bool(torch.isfinite(discard).all()) and float(discard.max()) == 1.0,
          "the rollout with --discard-ratio 0.1 is not a finite mask with maximum 1")
    hold_first_inputs(mods, rollout_in, vit_kernels, "rollout", results)
    del cfg, engine, tower, attns, rollout_in

    # the commands, at full width on synthetic data; without matplotlib their
    # drawing is replaced by a recorder of the overlays it would draw
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    viz = importlib.import_module("clip_for_dl_tpu_torch.utils.visualization")
    plots = importlib.util.find_spec("matplotlib") is not None
    drawn = {}

    def record(image, path=None, title=""):
        drawn[os.path.basename(path)] = (image.shape, float(image.min()), float(image.max()))
        return path

    if not plots:
        print("  gradcam and rollout commands: matplotlib is not installed on this machine, "
              "so their PNGs are NOT written: each overlay is recorded (name, shape, range) "
              "where the command would draw it; the files wait for matplotlib")
    labels = SyntheticMultiViewDataset(16, 224, 1)[0]["labels"]
    positive = [c for c, v in enumerate(labels) if v > 0] or [0]
    sides = ("frontal", "lateral")
    runs = (
        ("gradcam", ["--flash-attention", "--bert-fused-mlp"], "cli_gradcam",
         {f"sample0_{DISEASE_LABELS[c].replace(' ', '_')}_{v}.png"
          for c in positive for v in sides}, bank_kernels),
        ("rollout", ["--fused-mlp", "--flash-attention", "--discard-ratio", "0.1"],
         "cli_rollout", {f"sample0_{v}.png" for v in sides}, vit_kernels),
    )
    for command, flags, path, want, hold in runs:
        log_dir = f"{workdir}/{command}"
        out = io.StringIO()
        drawn.clear()
        inputs_kept, inputs = first_inputs(mods, hold)
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        with ExitStack() as stack:
            stack.enter_context(inputs_kept)
            if not plots:
                stack.enter_context(mock.patch.object(viz, "save_or_show_image", record))
            stack.enter_context(redirect_stdout(out))
            rc = timed(command, lambda: cli.main([command, "--synthetic", *flags,
                                                  "--log-dir", log_dir]))
        check(rc == 0, f"{command} exited with {rc}: {out.getvalue()[-2000:]}")
        by_path[path] = dict(_build.LAUNCHES)
        check_launched(mods, by_path[path], path)
        written = set(os.listdir(f"{log_dir}/{command}")) if plots else set(drawn)
        print(f"  {command} {' '.join(flags)}: exit 0 in {walls[command]:.1f} s on {card}, "
              f"{len(written)} overlays {'written' if plots else 'recorded'}; launches "
              f"{by_path[path]}")
        check(written == want, f"{command} wrote {sorted(written)}, not {sorted(want)}")
        check(all(shape == (224, 224, 3) and lo >= 0.0 and hi <= 1.0
                  for shape, lo, hi in drawn.values()),
              f"{command}'s overlays are not [224, 224, 3] in [0, 1]: {drawn}")
        hold_first_inputs(mods, inputs, hold, command, results)
        del inputs
    b3 = by_path["cli_rollout"].get(KERNELS["flash_attention"][0], 0)
    check(b3 == 0, f"the rollout command launched B3 {b3} times")
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


EXPORT_SOURCE = 512  # the side of the exported scorers' uint8 input (phase 14)
# /predict requests each exported server answers: one at a time, then
# clients posting at once
EXPORT_ALONE, EXPORT_CLIENTS, EXPORT_PER_CLIENT = 8, 4, 4


def export_phase14(_build, mods, dev, seed: int, card: str, workdir: str,
                   results: dict) -> dict:
    """Phase 14: the export tool on phase 9's adapter checkpoint, ``serve
    --exported`` with both heads, the programs against the live engines on
    the folded weights, and the library exports of the flash, fused-MLP
    BERT and the fused-MLP ViT on the card. Returns the launches of its
    paths."""
    import io
    import os
    import threading
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch import export
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, ZeroShotConfig, get_preset
    from clip_for_dl_tpu_torch.inference import AdapterEngine, load_trained_model
    from clip_for_dl_tpu_torch.serving import decode_request_image
    from clip_for_dl_tpu_torch.testing.png import encode_png
    from clip_for_dl_tpu_torch.tools import export_inference
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t_phase = time.perf_counter()
    work9, work = f"{workdir}/cli", f"{workdir}/export"
    art, lib = f"{work}/artifact", f"{work}/library"
    os.makedirs(lib)
    by_path, walls = {}, {}

    def mb(path):
        return os.path.getsize(path) / 1e6

    # -- 1. the tool, traced on the CPU at full width ------------------------------------
    t0 = time.perf_counter()
    out = io.StringIO()
    with redirect_stdout(out):
        rc = export_inference.main([
            "--checkpoint", f"{work9}/adapter", "--out", art, "--vocab", f"{work9}/vocab.txt",
            "--stablehlo", "--dtype", "bfloat16", "--source-size", str(EXPORT_SOURCE), "--cpu"])
    walls["export tool (CPU)"] = time.perf_counter() - t0
    check(rc == 0, f"export_inference exited with {rc}")
    with open(f"{art}/manifest.json") as f:
        manifest = json.load(f)
    files = (export.SCORER_FILE, export.SINGLEVIEW_FILE, export.ADAPTER_FILE,
             export.TEXT_ENCODER_FILE, "weights.safetensors")
    for line in out.getvalue().splitlines():
        print(f"  {line}")
    print(f"export_inference --stablehlo --dtype bfloat16 --source-size {EXPORT_SOURCE} --cpu "
          f"on phase 9's adapter checkpoint: {walls['export tool (CPU)']:.1f} s on the CPU; "
          + ", ".join(f"{n} {mb(f'{art}/{n}'):.1f} MB" for n in files)
          + f"; traced on {manifest['stablehlo']['traced_on']} with torch "
          f"{manifest['stablehlo']['torch_version']}")

    # -- 2. the live engines on the card: the folded weights, the baked bank --------------
    pre = manifest["preprocess"]
    mean, std, size = tuple(pre["mean"]), tuple(pre["std"]), pre["image_size"]
    t0 = time.perf_counter()
    programs = {"zeroshot": export.ExportedEngine(art, device=dev),
                "adapter": export.ExportedEngine(art, module=export.ADAPTER_FILE, device=dev)}
    torch.cuda.synchronize(dev)
    walls["load both programs onto the card"] = time.perf_counter() - t0
    check(all(p.device == dev and p.image_size == EXPORT_SOURCE for p in programs.values()),
          "the programs did not load onto the card at 512")
    bank = programs["zeroshot"].exported.state_dict["text_features"]
    folded = export_inference.load_folded_model(art, device=dev)
    zs_config = ZeroShotConfig(**manifest["zeroshot"])
    live = {"zeroshot": ZeroShotEngine(folded, None, DISEASE_LABELS, zs_config, mean, std, size,
                                       compute_dtype=torch.bfloat16),
            "adapter": AdapterEngine(folded, mean, std, size, torch.bfloat16)}
    live["zeroshot"].text_features = bank

    rng = np.random.default_rng(seed + 53)
    n_req = EXPORT_ALONE + EXPORT_CLIENTS * EXPORT_PER_CLIENT
    rgb = grey_images(rng, 3 * n_req, EXPORT_SOURCE).reshape(
        n_req, 3, EXPORT_SOURCE, EXPORT_SOURCE).transpose(0, 2, 3, 1)
    pngs = [encode_png(np.ascontiguousarray(im)) for im in rgb]
    decoded = np.stack([decode_request_image(b, "image/png", EXPORT_SOURCE) for b in pngs])
    check(np.array_equal(decoded, rgb), "the request PNGs did not decode to their images")
    imgs = torch.from_numpy(decoded).to(dev)

    # both programs in this process against the live engines, at b = 1, 3, 16
    cases = [(head, b) for head in ("zeroshot", "adapter") for b in (1, 3, 16)]
    stack, kept = first_inputs(mods, dict.fromkeys(("similarity", "image_prep")))
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    with stack:
        got = {(h, b): programs[h].logits(imgs[:b]) for h, b in cases}
    torch.cuda.synchronize(dev)
    by_path["export_programs"] = dict(_build.LAUNCHES)
    check_launched(mods, by_path["export_programs"], "export_programs")
    worst = {(h, b): float(np.abs(got[h, b] - live[h].logits(imgs[:b])).max())
             for h, b in cases}
    print("the programs on the card against the live engines on the folded weights, max "
          "|logits difference|: " + ", ".join(f"{h} b={b} {v:.3g}" for (h, b), v in worst.items()))
    hold_first_inputs(mods, kept, dict.fromkeys(("similarity", "image_prep")),
                      "export_programs", results)
    unfolded = load_trained_model(f"{work9}/adapter", get_preset("zero_shot").replace(
        model=export_inference.model_config(manifest)), torch.bfloat16, device=dev)
    gap_zs = ZeroShotEngine(unfolded, None, DISEASE_LABELS, zs_config, mean, std, size,
                            compute_dtype=torch.bfloat16)
    gap_zs.text_features = bank
    gap_ad = AdapterEngine(unfolded, mean, std, size, torch.bfloat16)
    gaps = [float(np.abs(gap_zs.logits(imgs) - live["zeroshot"].logits(imgs)).max()),
            float(np.abs(gap_ad.logits(imgs) - live["adapter"].logits(imgs)).max())]
    print(f"  the folded bf16 model against the unfolded one (a reading, not a bound), max "
          f"|logits difference| over {n_req} images: zero-shot {gaps[0]:.4g}, adapter "
          f"{gaps[1]:.4g}")
    del unfolded, gap_zs, gap_ad
    failures = [f"{h} b={b}: {v:.3g}" for (h, b), v in worst.items() if v > TOL["exported"]]

    # the answers the live engine gives at each bucket a request can run in
    # (the batcher pads with zero images; rows do not mix)
    @torch.inference_mode()
    def live_probs(head, bucket):
        rows = []
        for i in range(n_req):
            batch = torch.zeros((bucket, *imgs.shape[1:]), dtype=torch.uint8, device=dev)
            batch[0] = imgs[i]
            rows.append(torch.sigmoid(live[head]._dispatch(batch)[0][0]).cpu().numpy())
        return np.stack(rows)

    # -- 3. serve --exported, both heads ---------------------------------------------------
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if dev.type == "cuda":  # the child takes the card, as the smoke does
        env.pop("CLIP_FOR_DL_TPU_FORCE_CPU", None)
    for head, path in (("zeroshot", "export_serve"), ("adapter", "export_serve_adapter")):
        argv = ["serve", "--exported", art, "--head", head, "--host", "127.0.0.1", "--port",
                "0", "--log-dir", f"{work}/logs_{head}"]
        t0 = time.perf_counter()
        served = Served(argv, f"{work}/launches_{head}.json", env)
        start_s = time.perf_counter() - t0
        answers = [None] * n_req
        try:
            status, _, health, _ = served.request("GET", "/healthz")
            check(status == 200 and health["image_size"] == EXPORT_SOURCE
                  and health["checkpoint"] == art and health["buckets"] == [1, 4, 16, 64],
                  f"/healthz {status} {health}")
            t0 = time.perf_counter()
            for i in range(EXPORT_ALONE):
                answers[i] = served.request("POST", "/predict", pngs[i])
            alone_s = time.perf_counter() - t0

            def client(c):
                for j in range(EXPORT_PER_CLIENT):
                    k = EXPORT_ALONE + c * EXPORT_PER_CLIENT + j
                    answers[k] = served.request("POST", "/predict", pngs[k])

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(EXPORT_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            concurrent_s = time.perf_counter() - t0
            stats = served.request("GET", "/stats")[2]
        finally:
            rc = served.stop()
        with open(f"{work}/launches_{head}.json") as f:
            by_path[path] = json.load(f)
        check(rc == 0, f"serve --exported exited with {rc}: {''.join(served.lines[-20:])}")
        check_launched(mods, by_path[path], path)
        check(all(a is not None and a[0] == 200 for a in answers),
              f"{path}: a /predict request failed: "
              + str([a[:3] for a in answers if a is None or a[0] != 200][:3]))
        got = np.array([[a[2]["probs"][d] for d in DISEASE_LABELS] for a in answers])
        # each answer against the live engine at the bucket it ran in: alone
        # at 1, at once at 1, 4 or 16
        diffs = np.stack([np.abs(got - live_probs(head, b)).max(axis=1) for b in (1, 4, 16)])
        err_alone = float(diffs[0, :EXPORT_ALONE].max())
        err_all = float(diffs.min(axis=0).max())
        print(f"serve --exported --head {head} on {card}: up in {start_s:.1f} s (process, "
              f"program, warm-up of buckets 1/4/16/64 at {EXPORT_SOURCE}x{EXPORT_SOURCE}x3); "
              f"exit 0 on SIGINT; launches {by_path[path]}")
        print(f"  {EXPORT_ALONE} requests alone {EXPORT_ALONE / alone_s:.1f} req/s, "
              f"{EXPORT_CLIENTS} clients x {EXPORT_PER_CLIENT} at once "
              f"{EXPORT_CLIENTS * EXPORT_PER_CLIENT / concurrent_s:.1f} req/s, batch sizes "
              f"{stats['batch_size_hist']}; against the live engine: max |probability "
              f"difference| {err_alone:.3g} alone (bucket 1), {err_all:.3g} over every answer "
              f"at its nearest bucket (bound {TOL['service']})")
        if err_all > TOL["service"]:
            failures.append(f"{path}: answers {err_all:.3g} from the live engine")

    # -- 4. the library exports on the card: the kernels' BERT and ViT ------------------
    prompts = prompts_for_family("prediction", DISEASE_LABELS)
    for path, build_path in (("export_text", "serve"), ("export_vit", "serve_vit")):
        cfg, engine = build_engine(dev, seed, build_path)
        model = engine.model
        if path == "export_text":
            t0 = time.perf_counter()
            data = export.export_text_encoder(model, cfg.max_text_length)
            walls["export encode_text on the card"] = time.perf_counter() - t0
            file = f"{lib}/{export.TEXT_ENCODER_FILE}"
            with open(file, "wb") as f:
                f.write(data)
            program = export.ExportedTextEncoder(file, device=dev)
            enc = engine.tokenizer.encode([p for d in DISEASE_LABELS for p in prompts[d]],
                                          max_length=cfg.max_text_length)
            ids, mask = enc["input_ids"], enc["attention_mask"]
            live_fn = export.make_text_encoder(model)

            def run():
                return torch.from_numpy(program(ids, mask))

            def want_fn():
                with torch.inference_mode():
                    return live_fn(torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(mask).to(dev)).cpu()
            which = ("flash_attention", "mlp")
            shape = f"ids [{len(ids)}, {cfg.max_text_length}]"
        else:
            bank_v = engine.build_text_features(prompts)
            args = (bank_v, cfg.image_size, engine.mean, engine.std, engine.config.temperature)
            t0 = time.perf_counter()
            data = export.export_singleview_scorer(model, *args,
                                                   source_hw=(EXPORT_SOURCE, EXPORT_SOURCE))
            walls["export score_image (ViT) on the card"] = time.perf_counter() - t0
            file = f"{lib}/{export.SINGLEVIEW_FILE}"
            with open(file, "wb") as f:
                f.write(data)
            program = export.ExportedEngine(file, device=dev)
            live_fn = export.make_singleview_scorer(model, *args)

            def run():
                return torch.from_numpy(program.logits(imgs[:4]))

            def want_fn():
                with torch.inference_mode():
                    return live_fn(imgs[:4]).cpu()
            which = ("similarity", "image_prep", "flash_attention", "mlp_block")
            shape = f"images [4, {EXPORT_SOURCE}, {EXPORT_SOURCE}, 3]"
        stack, kept = first_inputs(mods, dict.fromkeys(which))
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        with stack:
            got = run()
        torch.cuda.synchronize(dev)
        by_path[path] = dict(_build.LAUNCHES)
        check_launched(mods, by_path[path], path)
        err = float((got - want_fn()).abs().max())
        print(f"{path}: {describe(cfg)} bf16, {os.path.basename(file)} exported on the card "
              f"({mb(file):.1f} MB), {shape}: max |difference| from the live forward {err:.3g} "
              f"(bound {TOL['exported']}); launches {by_path[path]}")
        if not (err <= TOL["exported"]):
            failures.append(f"{path}: {err:.3g} from the live forward")
        hold_first_inputs(mods, kept, dict.fromkeys(which), path, results)
        del engine, model, program, live_fn
    print(f"phase 14 on {card}: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    check(not failures, "phase 14: " + "; ".join(failures))
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


# -- phase 15: data parallelism over NCCL -------------------------------------------------

DP_BATCH = 128  # phase 15's global batch: the phase-A step's (a, b) and the ViT's (c)
DP_STEPS = 3  # steps of each route in phase 15 (a): the first held, the rest printed
DP_TIMED = 4  # steps of each route timed at the world size (the first not counted)
DP_ACCUM = 4  # phase 15 (c)'s microbatches
DP_CLI_BATCH = 16  # phase 15 (d)'s pretrain batch: two steps of 32 synthetic pairs
DP_TIMEOUT = 480  # seconds the phase's torchrun may take, the build's load included
# a collective's wait in phase 15's ranks: a rank that fails leaves the
# others waiting, and the phase must end inside the call
DP_PG_TIMEOUT = 120


def dp_phase15(_build, mods, dev, seed: int, card: str, workdir: str, results: dict) -> dict:
    """Phase 15: ``torchrun --standalone --nproc-per-node <cards>`` of this
    script's rank program (:func:`phase15_rank`, ``--phase15-rank``), each
    rank on its card over NCCL; then the checkpoint of its ``pretrain``
    restored into a single-device ``zeroshot`` in this process, the
    probabilities against the group's. Returns the launches by path and
    rank (``path@rankN``)."""
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    w = f"{workdir}/phase15"
    os.makedirs(w, exist_ok=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", str(ROOT / "chip_smoke.py"), "--phase15-rank", w,
           "--seed", str(seed)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"phase 15's ranks ran past {DP_TIMEOUT} s: "
                           f"{(exc.stdout or '')[-3000:]}")
    wall = time.perf_counter() - t0
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"phase 15's torchrun exited with {proc.returncode}")
    ranks_out = []
    for r in range(world):
        with open(f"{w}/rank{r}.json") as f:
            ranks_out.append(json.load(f))
    by_path = {}
    for r, out in enumerate(ranks_out):
        check(out["ok"], f"phase 15, rank {r} did not finish")
        for path, launches in out["launches"].items():
            check_launched(mods, launches, path)
            by_path[f"{path}@rank{r}"] = launches
        for name, v in out["results"].items():
            results.setdefault(name, {})["max_abs_err"] = max(
                v["max_abs_err"], results.get(name, {}).get("max_abs_err", 0.0))
    written = [out["written"] for out in ranks_out]
    print(f"phase 15 (d): files written by each rank's commands: "
          f"{[len(x) for x in written]} (rank 0: {sorted(os.path.basename(p) for p in written[0])})")
    check(written[0] and not any(written[1:]), "a rank other than 0 wrote a file")

    # (d) the checkpoint the group wrote, in a plain single-device zeroshot
    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    engine_module = importlib.import_module("clip_for_dl_tpu_torch.zeroshot.engine")
    got, stream = [], engine_module.ZeroShotEngine.stream_logits

    def recording(self, batches):
        for batch, logits in stream(self, batches):
            got.append(np.asarray(logits, np.float64))
            yield batch, logits

    argv = dp_zeroshot_argv(workdir, f"{w}/zs_single")
    out = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(engine_module.ZeroShotEngine, "stream_logits", recording), \
            redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"the single-device zeroshot exited with {rc}: {out.getvalue()[-2000:]}")
    single = 1 / (1 + np.exp(-np.concatenate(got)))
    group = 1 / (1 + np.exp(-np.load(f"{w}/zs_dp_logits.npy")))
    check(single.shape == group.shape, f"zeroshot: {single.shape} vs {group.shape}")
    diff = float(np.abs(single - group).max())
    print(f"phase 15 (d): the group's checkpoint in a single-device zeroshot "
          f"({time.perf_counter() - t0:.1f} s): {single.shape[0]} views x {single.shape[1]} "
          f"classes, probabilities max |difference| {diff:.3e} from the group's "
          f"(tol {TOL['eval_vs_plain']:.0e})")
    check(diff <= TOL["eval_vs_plain"], "the group's zeroshot differs from the single device's")
    # each rank of the group scored its 1/world of every batch: the single
    # device scoring the same shares one after another (the engine's _logits
    # on each rank's rows, padded as the group pads) gives the group's
    # logits bit for bit, so the difference above is the batch size's
    shares, logits_fn = [], engine_module.ZeroShotEngine._logits

    def by_shares(self, imgs):
        n = imgs.shape[0]
        pad = -n % world
        if pad:
            imgs = torch.cat([imgs, imgs.new_zeros((pad, *imgs.shape[1:]))])
        m = imgs.shape[0] // world
        return torch.cat([logits_fn(self, imgs[r * m:(r + 1) * m]) for r in range(world)])[:n]

    got.clear()
    with mock.patch.object(engine_module.ZeroShotEngine, "stream_logits", recording), \
            mock.patch.object(engine_module.ZeroShotEngine, "_logits", by_shares), \
            redirect_stdout(io.StringIO()):
        rc = cli.main(dp_zeroshot_argv(workdir, f"{w}/zs_shares"))
    check(rc == 0, f"the single-device zeroshot by shares exited with {rc}")
    by_rank = np.concatenate(got)
    exact = np.array_equal(by_rank, np.load(f"{w}/zs_dp_logits.npy"))
    print(f"phase 15 (d): the single device scoring each rank's {world}-th of every batch "
          f"apart: logits {'bit for bit' if exact else 'NOT bit for bit'} the group's "
          f"(max |difference| {float(np.abs(by_rank - np.load(f'{w}/zs_dp_logits.npy')).max()):.3e})")
    check(exact, "the group's zeroshot differs from the single device's on the same shares")
    torch.cuda.empty_cache()
    print(f"phase 15 on {card}: torchrun {wall:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


def dp_zeroshot_argv(workdir: str, log_dir: str) -> list:
    """``zeroshot`` on phase 9's files with the checkpoint phase 15's
    pretrain wrote."""
    work, kaggle = f"{workdir}/cli", f"{workdir}/kaggle"
    return ["zeroshot", "--reports-csv", f"{work}/labeled.csv", "--projections-csv",
            f"{kaggle}/indiana_projections.csv", "--image-dir",
            f"{kaggle}/images/images_normalized", "--image-cache", f"{work}/cache", "--vocab",
            f"{work}/vocab.txt", "--flash-attention", "--bert-fused-mlp", "--checkpoint",
            f"{workdir}/phase15/ckpt", "--log-dir", log_dir]


def phase15_rank(w: str, seed: int) -> int:
    """One rank of phase 15 (``--phase15-rank W``, under torchrun): joins the
    NCCL group, loads the kernels the parent built, runs (a) to (d) and
    writes ``W/rank{r}.json`` (launches by path, the kernels' first-input
    holds, readings, the files its commands wrote). Rank 0 prints."""
    import datetime
    import os

    import torch

    _build, mods = import_port()
    from clip_for_dl_tpu_torch.parallel import multihost

    dev = multihost.init_process_group(device="cuda",
                                       timeout=datetime.timedelta(seconds=DP_PG_TIMEOUT))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    out = {"ok": False, "launches": {}, "results": {}, "readings": {}, "written": []}
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        t0 = time.perf_counter()
        _build.build()
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        print(f"phase 15: world size {world} over NCCL {nccl} (torch {torch.__version__}); "
              f"rank 0 on {torch.cuda.get_device_name(dev)}; kernels loaded in "
              f"{time.perf_counter() - t0:.1f} s")
        dp_steps15(_build, mods, dev, seed, out)
        dp_accum15(_build, mods, dev, seed, out)
        dp_cli15(_build, mods, dev, w, out)
        out["ok"] = True
    finally:
        with open(f"{w}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        multihost.destroy()
    return 0


def _route_tols(compute):
    """(loss rel, gradient cosine) bounds of a route: phase 7's on the fp32
    route, phase 4's on the bf16 one."""
    import torch

    if compute == torch.float32:
        return TOL["fp32_loss_rel"], TOL["fp32_grad_cos"]
    return TOL["train_loss_rel"], TOL["grad_cos"]


def dp_steps15(_build, mods, dev, seed: int, out: dict) -> None:
    """Phase 15 (a) and (b): the phase-A step (ResNet-50 + BERT-base, 200
    tokens, dropout 0) at a global batch of DP_BATCH, through parallel.dp
    (this rank's rows, global BatchNorm and loss, the gradients'
    all-reduce before the clip) against the single-device step on the whole
    batch, DP_STEPS steps of each from the same weights, on the fp32 route
    (fp32_compute: fp32 attention kernels, TF32 off) and on the bf16 route;
    the local-loss forms against the global ones; then both routes timed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.parallel import data_parallel_step, replicate_state
    from clip_for_dl_tpu_torch.parallel.multihost import assert_same_across_processes
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    group = dist.group.WORLD
    world = dist.get_world_size()
    t0 = time.perf_counter()
    preset, cfg, model = train_model(dev, seed, "pretrain_clip")
    groups = [g.name for g in preset.train.groups]
    label_fn, lrs = make_label_fn(groups), base_lrs(preset)
    batch = train_batch(np.random.default_rng(seed + 15), tokenizer(), dev, DP_BATCH, TRAIN_LEN)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    print(f"phase 15 (a): {describe(cfg)}; global batch {DP_BATCH} ({DP_BATCH // world} a "
          f"rank), {TRAIN_LEN} tokens, dropout 0; built in {time.perf_counter() - t0:.1f} s")

    def steps(compute, dp: bool, n: int, **kw):
        """n steps from the initial weights: (losses, the first step's group
        gradients, the seconds of each step)."""
        model.load_state_dict(init)
        opt, step = pretrain_step(model, preset, cfg, compute, **({"group": group, **kw}
                                                                   if dp else kw))
        state = TrainState(model, opt)
        if dp:
            replicate_state(state, group)
            step = data_parallel_step(step, group)
        losses, grads, times = [], None, []
        for i in range(n):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            losses.append(float(step(state, batch, lrs)[1]["loss"]))  # syncs the step
            times.append(time.perf_counter() - t)
            if i == 0:
                grads = group_grads(model, label_fn)
        if dp:
            assert_same_across_processes(
                float(sum(float(p.double().sum()) for p in model.parameters())),
                "the replicated parameters")
        return losses, grads, times

    def against(what, got, want, compute, loss_tol=None, cos_tol=None):
        """The first step's loss and gradients at the route's bounds (or
        the ones given); the later losses printed: Adam's first update moves
        each element by about ±lr whatever its gradient's size, so the
        trajectory after it (at random init the projectors' 1e-3 throws the
        loss to ~50) measures the dynamics, not the step."""
        route_loss_tol, route_cos_tol = _route_tols(compute)
        loss_tol, cos_tol = loss_tol or route_loss_tol, cos_tol or route_cos_tol
        rel = [abs(a - b) / abs(b) for a, b in zip(got[0], want[0])]
        print(f"  {what}: losses {['%.6f' % x for x in got[0]]} vs "
              f"{['%.6f' % x for x in want[0]]} (rel {', '.join('%.2e' % r for r in rel)}; "
              f"the first step's tol {loss_tol:.0e})")
        compare_groups(f"phase 15, {what}", got[1], want[1], groups, cos_tol)
        check(all(np.isfinite(got[0])) and rel[0] <= loss_tol,
              f"phase 15, {what}: the first step's loss differs")

    def dp_tols(route):
        """(loss rel, group -> cosine) of the data-parallel step against the
        plain one: the route's bounds, but TOL["dp_bn"]'s where the
        BatchNorm arithmetic reaches."""
        loss_tol, cos_tol = _route_tols(torch.float32 if route == "fp32" else torch.bfloat16)
        loss_own, cos_own = TOL["dp_bn"][route]
        return max(loss_tol, loss_own), {**dict.fromkeys(groups, cos_tol), **cos_own}

    def bn_control(plain, compute, route):
        """The planted fault that the bounds must catch: each half of the
        batch normalized by its own statistics (rank-local BatchNorm at two
        ranks), one step through parallel.dp; it must fail the loss's bound
        and every group's."""
        from clip_for_dl_tpu_torch.models import resnet

        real = resnet._global_bn

        def halves(x, bn, group):
            parts = [real(h, bn, group) for h in x.chunk(2)]
            return (torch.cat([o for o, _, _ in parts]), sum(m for _, m, _ in parts) / 2,
                    sum(v for _, _, v in parts) / 2)

        with mock.patch.object(resnet, "_global_bn", halves):
            fault = steps(compute, True, 1)
        cos = {g: cosine(fault[1][g], plain[1][g]) for g in groups}
        rel = abs(fault[0][0] - plain[0][0]) / abs(plain[0][0])
        loss_tol, cos_tol = dp_tols(route)
        print(f"  control on the {route} route, BatchNorm statistics of each half of the batch: "
              f"loss rel {rel:.2e} (must be above {loss_tol:.0e}), gradient cosines "
              f"{', '.join(f'{g} {c:.6f}' for g, c in cos.items())} (each must be below "
              f"its bound)")
        out["readings"][f"bn_control_{route}"] = {"loss_rel": rel, "cos": cos}
        missed = [g for g in groups if cos[g] >= cos_tol[g]] + ["loss"] * (rel <= loss_tol)
        check(not missed, f"phase 15 (a): the {route} bounds of {missed} do not catch "
                          "BatchNorm statistics of half the batch")

    # the kernels each route runs (the fp32 route's BERT has no fused MLP),
    # each held at its first inputs on the path
    route_kernels = {"bf16": dict.fromkeys(("image_prep", "flash_attention",
                                            "flash_attention_bwd", "mlp", "mlp_bwd")),
                     "fp32": dict.fromkeys(("image_prep", "flash_attention",
                                            "flash_attention_bwd"))}
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        for route, compute in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            path = "dp_step" if route == "bf16" else "dp_step_fp32"
            which = route_kernels[route]
            ctx = fp32_compute(model) if route == "fp32" else ExitStack()
            with ctx:
                stack, kept = first_inputs(mods, which)
                torch.cuda.synchronize(dev)
                _build.reset_launches()
                with stack:
                    dp = steps(compute, True, DP_STEPS)
                torch.cuda.synchronize(dev)
                out["launches"][path] = dict(_build.LAUNCHES)
                plain = steps(compute, False, DP_STEPS)
                against(f"the {route} step over {world} rank(s) vs one device", dp, plain,
                        compute, *dp_tols(route))
                bn_control(plain, compute, route)
                print(f"  the {route} data-parallel step's kernels at their first inputs:")
                hold_first_inputs(mods, kept, which, f"phase 15's {route} dp step",
                                  out["results"])
                if route == "fp32":  # (b)
                    stack, kept = first_inputs(mods, which)
                    torch.cuda.synchronize(dev)
                    _build.reset_launches()
                    with stack:
                        local = {name: steps(compute, True, 1, loss_name=name, local_loss=True)
                                 for name in ("clip_self_distill", "siglip")}
                    torch.cuda.synchronize(dev)
                    out["launches"]["dp_local"] = dict(_build.LAUNCHES)
                    for loss_name, got in local.items():
                        full = steps(compute, True, 1, loss_name=loss_name)
                        ring = loss_name == "siglip"
                        against(f"(b) {loss_name}, {'the ring' if ring else 'the local-loss form'}"
                                " vs the all-gather form", got, full, compute)
                    print("  the local-loss steps' kernels at their first inputs:")
                    hold_first_inputs(mods, kept, which, "phase 15's local-loss steps",
                                      out["results"])
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    rates = {}
    for name, dp in (("dp", True), ("plain", False)):
        t = steps(torch.bfloat16, dp, DP_TIMED)[2][1:]
        rates[name] = DP_BATCH * len(t) / sum(t)
    print(f"phase 15 (a): bf16 step, global batch {DP_BATCH}: {rates['dp']:.1f} samples/s "
          f"through parallel.dp over {world} rank(s), {rates['plain']:.1f} samples/s on the "
          f"single-device step (steps 1-{DP_TIMED - 1}, synced; dp / plain "
          f"{rates['dp'] / rates['plain']:.3f})")
    out["readings"]["samples_per_s"] = rates
    del model, init
    torch.cuda.empty_cache()


def dp_accum15(_build, mods, dev, seed: int, out: dict) -> None:
    """Phase 15 (c): GradCache on the ViT-B/16 tower (LayerNorm only, the
    training MLP kernels in both towers): the accumulating step in DP_ACCUM
    microbatches through parallel.dp (each rank its share of each global
    microbatch) against the single-device full-batch step on the same
    DP_BATCH pairs, bf16, one step each from the same weights: the loss and
    each group's gradient at phase 4's bounds; the accumulating step's peak
    below the full step's."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.parallel import data_parallel_step, replicate_state
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import (
        TrainState, make_accum_clip_pretrain_step, make_label_fn,
    )

    group = dist.group.WORLD
    preset, cfg, model = train_model(dev, seed, "vit", vit_fused_mlp_train=True)
    groups = [g.name for g in preset.train.groups]
    label_fn, lrs = make_label_fn(groups), base_lrs(preset)
    batch = train_batch(np.random.default_rng(seed + 16), tokenizer(), dev, DP_BATCH, TRAIN_LEN)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    init = {k: v.clone() for k, v in model.state_dict().items()}
    def accum(m, opt, lf, **kw):
        return make_accum_clip_pretrain_step(m, opt, lf, DP_ACCUM, **kw)

    def one_step(dp: bool):
        model.load_state_dict(init)
        opt, step = pretrain_step(model, preset, cfg, **({"group": group, "make": accum}
                                                          if dp else {}))
        state = TrainState(model, opt)
        if dp:
            replicate_state(state, group)
            step = data_parallel_step(step, group, microbatches=DP_ACCUM)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        loss = float(step(state, batch, lrs)[1]["loss"])
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        return loss, group_grads(model, label_fn), peak

    vit_kernels = dict.fromkeys(("image_prep", "flash_attention", "flash_attention_bwd", "mlp",
                                 "mlp_bwd"))
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        full = one_step(False)
        stack, kept = first_inputs(mods, vit_kernels)
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        with stack:
            acc = one_step(True)
        torch.cuda.synchronize(dev)
        out["launches"]["dp_accum"] = dict(_build.LAUNCHES)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    rel = abs(acc[0] - full[0]) / abs(full[0])
    print(f"phase 15 (c): {describe(cfg)}, training MLP in the ViT; GradCache in {DP_ACCUM} "
          f"microbatches over {dist.get_world_size()} rank(s) vs the full batch of "
          f"{DP_BATCH}: loss {acc[0]:.6f} vs {full[0]:.6f} (rel {rel:.2e}, tol "
          f"{TOL['train_loss_rel']:.0e}); peak above the resident state {acc[2]:.2f} GiB vs "
          f"{full[2]:.2f} GiB")
    check(np.isfinite(acc[0]) and rel <= TOL["train_loss_rel"],
          "phase 15 (c): the accumulating step's loss differs")
    compare_groups("phase 15 (c)", acc[1], full[1], groups, TOL["grad_cos"])
    check(acc[2] < full[2], "phase 15 (c): the accumulating step's peak is not below the "
                            "full step's")
    out["readings"]["vit_peak_gib"] = {"accum": acc[2], "full": full[2]}
    print("  the accumulating ViT step's kernels at their first inputs:")
    hold_first_inputs(mods, kept, vit_kernels, "phase 15's GradCache step", out["results"])
    del model, init
    torch.cuda.empty_cache()


def dp_cli15(_build, mods, dev, w: str, out: dict) -> None:
    """Phase 15 (d): the command line over the group, in this rank:
    ``pretrain --accum-steps 2`` at full width on phase 9's vocabulary, two
    steps of DP_CLI_BATCH synthetic pairs and a checkpoint (path
    cli_dp_pretrain), then ``zeroshot`` of that checkpoint on phase 9's
    files (path cli_dp_zeroshot, its logits kept for the parent). The files
    each rank's commands write are recorded; B2, B3, B6, B4, B8 and B1 held
    at their first inputs."""
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.testing.ranks import recorded_writes

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    engine_module = importlib.import_module("clip_for_dl_tpu_torch.zeroshot.engine")
    workdir = os.path.dirname(w)
    vocab = f"{workdir}/cli/vocab.txt"
    pretrain = ["pretrain", "--vocab", vocab, "--flash-attention", "--bert-fused-mlp",
                "--synthetic", "--synthetic-samples", str(2 * DP_CLI_BATCH), "--batch-size",
                str(DP_CLI_BATCH), "--epochs", "1", "--accum-steps", "2", "--checkpoint-dir",
                f"{w}/ckpt", "--log-dir", f"{w}/logs"]
    logits, stream = [], engine_module.ZeroShotEngine.stream_logits

    def recording(self, batches):
        for batch, lg in stream(self, batches):
            logits.append(np.asarray(lg, np.float64))
            yield batch, lg

    for path, argv, which in (
            ("cli_dp_pretrain", pretrain,
             ("image_prep", "flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd")),
            ("cli_dp_zeroshot", dp_zeroshot_argv(workdir, f"{w}/zs_dp"),
             ("similarity", "image_prep", "flash_attention", "mlp"))):
        stack, kept = first_inputs(mods, dict.fromkeys(which))
        text = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        with stack, recorded_writes() as written, redirect_stdout(text), \
                mock.patch.object(engine_module.ZeroShotEngine, "stream_logits", recording):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        check(rc == 0, f"phase 15 (d): {argv[0]} exited with {rc}: {text.getvalue()[-2000:]}")
        out["launches"][path] = dict(_build.LAUNCHES)
        out["written"] += written
        print(f"phase 15 (d): {' '.join(argv[:1] + argv[1:][-12:])} over "
              f"{dist.get_world_size()} rank(s): exit 0 in {time.perf_counter() - t0:.1f} s; "
              f"launches {out['launches'][path]}")
        hold_first_inputs(mods, kept, dict.fromkeys(which), path, out["results"])
        torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        np.save(f"{w}/zs_dp_logits.npy", np.concatenate(logits))


# -- phase 16: tensor and sequence parallelism, serving over a group -----------------------

TP_DEGREES = (2, 4)  # the shares phase 16 (a) runs on the one card
TP_VIT_BATCH = 64  # images of phase 16 (a)'s ViT-B/16 layer (197 tokens each)
TP_STEP_BATCH = 128  # phase 16 (b)'s step and text batch (the phase-A step's)
TP_ZS_BATCHES = 20  # phase 16 (b)'s engine batches of BATCH images a timed window
TP_ZS_WINDOWS = 5  # phase 16 (b)'s timed windows an engine (the median and the spread)
TP_TIMEOUT = 420  # seconds phase 16's torchrun may take, the build's load included
TP_SERVE_REQUESTS = 48  # requests to a group server a timed window, 8 clients at once
TP_SERVE_WINDOWS = 3  # phase 16 (c)'s timed windows a server (the median and the spread)


def _tp_mesh(t: int, r: int):
    """The layout of rank r's share among t, with no group: a share run
    alone on this card (``tensor_parallel_(..., share=r)``)."""
    from clip_for_dl_tpu_torch.parallel.common import Mesh2D, rank_grid

    return Mesh2D(rank_grid(t, t), ("data", "model"), r, None, None)


def tp_heads16(mods, dev, seed: int, results: dict) -> None:
    """Phase 16 (a), the kernels: B3 and B6 on each tp rank's heads with
    ``head_offset`` bit for bit the unsharded kernel's heads (dropout 0.1
    at the train shape), their masks against the plain version's on the
    probe, offset 0 bit for bit the call without the argument; then the
    times of B3/B6 at H/tp heads and of B4/B8 at F/tp beside their bounds,
    plain versions and library calls."""
    import torch

    fa, mlp = mods["flash_attention"], mods["mlp_train"]
    g = torch.Generator(dev).manual_seed(seed + 16)
    B, N, H, D, HID, F = TRAIN_BATCH, TRAIN_LEN, 12, 64, 768, 3072
    qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=g).bfloat16()
    lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
    bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
    drop = dict(dropout_rate=0.1, dropout_seeds=fa.dropout_seeds(g, B, dev))
    do = torch.randn(B, N, H * D, device=dev, generator=g).bfloat16()
    full = fa.flash_attention_packed(qkv, H, bias, **drop)
    dfull = fa.flash_attention_packed_bwd(qkv, do, H, bias, **drop)
    check(torch.equal(fa.flash_attention_packed(qkv, H, bias, **drop, head_offset=0), full)
          and torch.equal(fa.flash_attention_packed_bwd(qkv, do, H, bias, **drop,
                                                        head_offset=0), dfull),
          "B3/B6 at head_offset 0 differ from the call without it")
    pq, pdo, pbias = dropout_probe(B, N, H, D, dev)
    heads = lambda t, sl: torch.cat([x[:, :, sl].reshape(B, N, -1) for x in
                                     t.view(B, N, 3, H, D).unbind(2)], -1)
    for t in TP_DEGREES:
        h = H // t
        for r in range(t):
            sl = slice(r * h, (r + 1) * h)
            local, dlocal = heads(qkv, sl), do.view(B, N, H, D)[:, :, sl].reshape(B, N, -1)
            kw = dict(drop, head_offset=r * h)
            got = fa.flash_attention_packed(local, h, bias, **kw)
            check(torch.equal(got, full.view(B, N, H, D)[:, :, sl].reshape(B, N, -1)),
                  f"B3 at heads {sl.start}-{sl.stop - 1} of {H} differs from the unsharded heads")
            dgot = fa.flash_attention_packed_bwd(local, dlocal, h, bias, **kw)
            check(torch.equal(dgot.view(B, N, 3, h, D),
                              dfull.view(B, N, 3, H, D)[:, :, :, sl]),
                  f"B6 at heads {sl.start}-{sl.stop - 1} of {H} differs from the unsharded heads")
            plocal = heads(pq, sl)
            pdl = pdo.view(B, N, H, D)[:, :, sl].reshape(B, N, -1).contiguous()
            pgot = fa.flash_attention_packed(plocal, h, pbias, **kw)
            pwant = fa.flash_attention_packed_reference(plocal, h, pbias, **drop,
                                                        head_offset=r * h)
            gdv = fa.flash_attention_packed_bwd(plocal, pdl, h, pbias, **kw).view(
                B, N, 3, h, D)[:, :, 2]
            wdv = fa.flash_attention_packed_bwd_reference(
                plocal, pdl, h, pbias, **drop, head_offset=r * h).view(B, N, 3, h, D)[:, :, 2]
            check(torch.equal(pgot != 0, pwant != 0) and torch.equal(gdv != 0, wdv != 0),
                  f"B3/B6 dropout masks at head_offset {r * h} differ from the plain version's")
    print(f"  B3 and B6 with dropout 0.1 at [{B}, {N}], {H} heads: each rank's heads with "
          f"head_offset (tp {' and '.join(map(str, TP_DEGREES))}) bit for bit the unsharded "
          "kernel's heads, forward and backward; their masks (the probe) bit for bit the "
          "plain version's; head_offset 0 bit for bit the call without it")
    for t in TP_DEGREES:
        h = H // t
        local = heads(qkv, slice(0, h))
        dl = do.view(B, N, H, D)[:, :, :h].reshape(B, N, -1).contiguous()
        compare("flash_attention", fa.flash_attention_packed(local, h, bias, **drop),
                fa.flash_attention_packed_reference(local, h, bias, **drop),
                TOL["flash_attention"], results)
        compare_grads("flash_attention_bwd", fa._kernel_bwd(local, dl, h, bias, **drop),
                      fa.flash_attention_packed_bwd_reference(local, dl, h, bias, **drop),
                      "packed", results, h)
        out = fa.flash_attention_packed(local, h, bias, **drop)
        extra_times(f"B3 at {h} heads (tp {t}), dropout 0.1, [{B}, {N}, {3 * h * D}]",
                    lambda: fa.flash_attention_packed(local, h, bias, **drop),
                    lambda: fa.flash_attention_packed_reference(local, h, bias, **drop),
                    4 * B * h * N * N * D, (local, bias, drop["dropout_seeds"], out),
                    sdpa_ms(*heads_of(local, h), bias))
        dq = fa._kernel_bwd(local, dl, h, bias, **drop)
        extra_times(f"B6 at {h} heads (tp {t}), dropout 0.1",
                    lambda: fa._kernel_bwd(local, dl, h, bias, **drop),
                    lambda: fa.flash_attention_packed_bwd_reference(local, dl, h, bias, **drop),
                    10 * B * h * N * N * D, (local, dl, bias, drop["dropout_seeds"], dq),
                    sdpa_ms(*heads_of(local, h), bias, dl.view(B, N, h, D).transpose(1, 2)))
    R = B * N
    x = torch.randn(R, HID, device=dev, generator=g).bfloat16()
    dy = (torch.randn(R, HID, device=dev, generator=g) * 0.1).bfloat16()
    w1 = (torch.randn(F, HID, device=dev, generator=g) * 0.02).bfloat16()
    b1 = (torch.randn(F, device=dev, generator=g) * 0.02).bfloat16()
    w2 = (torch.randn(HID, F, device=dev, generator=g) * 0.02).bfloat16()
    zero = torch.zeros(HID, dtype=torch.bfloat16, device=dev)
    for t in TP_DEGREES:
        f = F // t
        w1s, b1s, w2s = w1[:f].contiguous(), b1[:f].contiguous(), w2[:, :f].contiguous()
        y = mlp._kernel(x, w1s, b1s, w2s, zero)
        compare("mlp", y, mlp.dense_gelu_dense_reference(x, w1s, b1s, w2s, zero), TOL["mlp"],
                results)
        gm = torch.empty(R, f, dtype=torch.bfloat16, device=dev).normal_()
        cublas = cuda_ms(lambda: (torch.matmul(x, w1s.T), torch.matmul(gm, w2s.T)), iters=10)
        fwd_ms, fwd_by, fwd_work = bound(4 * R * HID * f, (x, w1s, b1s, w2s, zero, y))
        print(f"  B4 at F {f} (tp {t}), [{R}, {HID}]: kernel "
              f"{cuda_ms(lambda: mlp._kernel(x, w1s, b1s, w2s, zero), iters=10):.4f} ms  plain "
              f"{cuda_ms(lambda: mlp.dense_gelu_dense_reference(x, w1s, b1s, w2s, zero), iters=10):.4f}"
              f" ms  bound {fwd_ms:.4f} ms by {fwd_by} ({fwd_work})  its two products in "
              f"cuBLAS {cublas:.4f} ms")
        got = mlp._kernel_bwd(x, w1s, b1s, w2s, dy)
        for name, a_, b_ in zip(("dx", "g", "dh"), got,
                                mlp.dense_gelu_dense_bwd_reference(x, w1s, b1s, w2s, dy)):
            print(f"    {name}:", end="")
            compare("mlp_bwd", a_, b_, TOL["bwd_rel"] * float(b_.float().abs().max()), results)
        dh = got[2]
        cublas = cuda_ms(lambda: (torch.matmul(x, w1s.T), torch.matmul(dy, w2s),
                                  torch.matmul(dh, w1s)), iters=5)
        bwd_ms, bwd_by, bwd_work = bound(6 * R * HID * f, (x, w1s, b1s, w2s, dy) + tuple(got))
        print(f"  B8 at F {f} (tp {t}): kernel "
              f"{cuda_ms(lambda: mlp._kernel_bwd(x, w1s, b1s, w2s, dy), iters=5):.4f} ms  plain "
              f"{cuda_ms(lambda: mlp.dense_gelu_dense_bwd_reference(x, w1s, b1s, w2s, dy), iters=5):.4f}"
              f" ms  bound {bwd_ms:.4f} ms by {bwd_by} ({bwd_work})  its three products in "
              f"cuBLAS {cublas:.4f} ms")
        del got, dh, gm
    torch.cuda.empty_cache()


def tp_layers16(_build, mods, dev, seed: int, results: dict) -> dict:
    """Phase 16 (a), the layers: a full-width BERT-base layer (dropout 0.1,
    B3/B6 and B4/B8) and a ViT-B/16 layer (B3/B6, B4/B8), bf16 on fp32
    masters in train mode, forward and backward, against every tp rank's
    share of it run one after another on this card (the partial products
    summed here, the masks drawn once): the output and the input gradient
    within TOL["tp_layer_rel"] of their largest entry, each weight's
    gradient (the shares' gathered) at cosine TOL["tp_grad_cos"]; each
    kernel held at the shares' first inputs. Returns the launches of each
    (layer, tp) path."""
    import copy

    import torch

    from clip_for_dl_tpu_torch.core.device import cast_in_forward, plain_name
    from clip_for_dl_tpu_torch.models import bert as bert_module
    from clip_for_dl_tpu_torch.models import init_weights
    from clip_for_dl_tpu_torch.models import vit as vit_module
    from clip_for_dl_tpu_torch.parallel import tp

    by_path = {}
    which = dict.fromkeys(("flash_attention", "flash_attention_bwd", "mlp", "mlp_bwd"))
    for kind in ("bert", "vit"):
        g = torch.Generator(dev).manual_seed(seed + 17)
        if kind == "bert":
            B, N = TRAIN_BATCH, TRAIN_LEN
            base = bert_module.BertLayer(768, 12, 3072, dropout=0.1, flash=True, fused_mlp=True)
            lengths = torch.randint(3, N + 1, (B, 1), device=dev, generator=g)
            bias = torch.where(torch.arange(N, device=dev)[None] < lengths, 0.0, -1e10)
            run = lambda layers, x: bert_module.layer_shares(
                layers, x, bias, torch.Generator(dev).manual_seed(seed))
        else:
            B, N = TP_VIT_BATCH, VIT_TOKENS
            base = vit_module.ViTEncoderLayer(768, 12, 3072, flash=True, fused_mlp_train=True)
            run = lambda layers, x: vit_module.layer_shares(layers, x)
        base = init_weights(base.to(dev), g).train()
        x = torch.randn(B, N, 768, device=dev, generator=g).bfloat16().requires_grad_()
        whole = cast_in_forward(tp.tensor_parallel_(copy.deepcopy(base), _tp_mesh(1, 0),
                                                    share=0), torch.bfloat16)
        want = run([whole], x)
        dy = (torch.randn(want.shape, device=dev, generator=g) * 0.1).bfloat16()
        want.backward(dy)
        wx, x.grad = x.grad.clone(), None
        wgrads = {plain_name(n): p.grad.float() for n, p in whole.named_parameters()}
        for t in TP_DEGREES:
            shares = [cast_in_forward(tp.tensor_parallel_(copy.deepcopy(base), _tp_mesh(t, r),
                                                          share=r), torch.bfloat16)
                      for r in range(t)]
            stack, kept = first_inputs(mods, which)
            torch.cuda.synchronize(dev)
            _build.reset_launches()
            with stack:
                got = run(shares, x)
                got.backward(dy)
            torch.cuda.synchronize(dev)
            path = f"tp_shares_{kind}_{t}"
            by_path[path] = dict(_build.LAUNCHES)
            check_launched(mods, by_path[path], path)
            errs = []
            for what, a, b in (("output", got.detach(), want.detach()),
                               ("input gradient", x.grad, wx)):
                err = float((a.float() - b.float()).abs().max())
                tol = TOL["tp_layer_rel"] * float(b.float().abs().max())
                errs.append(f"{what} {err:.3e} (tol {tol:.3e})")
                check(err <= tol, f"{path}: the {what} lies {err} from the unsharded layer's")
            worst, vanishing = (1.0, ""), []
            share_grads = [{plain_name(n): p.grad for n, p in s.named_parameters()}
                           for s in shares]
            top = max(float(w.norm()) for w in wgrads.values())
            for n, w in wgrads.items():
                gathered = tp.gather_tensor([sg[n] for sg in share_grads],
                                            tp.layer_spec(n, w)).float()
                if float(w.norm()) < 1e-3 * top:
                    # zero in exact arithmetic (the key bias: softmax ignores
                    # a shift of a row's logits): rounding noise, held in
                    # absolute terms against the layer's largest gradient
                    err = float((gathered - w).abs().max())
                    vanishing.append(f"{n} {err:.2e}")
                    check(err <= TOL["tp_layer_rel"] * float(max(
                        v.abs().max() for v in wgrads.values())),
                        f"{path}: {n}'s vanishing gradient lies {err} from the unsharded one")
                    continue
                cos = cosine(gathered.flatten(), w.flatten())
                worst = min(worst, (cos, n))
            check(worst[0] >= TOL["tp_grad_cos"], f"{path}: {worst[1]}'s gradient at cosine "
                  f"{worst[0]:.6f} from the unsharded layer's")
            print(f"  {kind} layer, {t} shares on {describe_shape(x)}: {'; '.join(errs)}; the "
                  f"weights' gradients at cosine >= {worst[0]:.6f} ({worst[1]}), those that "
                  f"vanish by |difference| {vanishing}; launches {by_path[path]}")
            hold_first_inputs(mods, kept, which, f"the {kind} layer's shares at tp {t}", results)
            x.grad = None
            del shares, got
        del whole, want, wgrads
        torch.cuda.empty_cache()
    return by_path


def describe_shape(t) -> str:
    return f"[{', '.join(map(str, t.shape))}] {str(t.dtype).replace('torch.', '')}"


def tp_phase16(_build, mods, dev, seed: int, card: str, workdir: str, results: dict) -> dict:
    """Phase 16: (a) the shares of tensor parallelism on this card;
    (b) ``torchrun --standalone --nproc-per-node <cards>`` of this script's
    rank program (:func:`phase16_rank`): the TP engine, the TP step and
    ``sequence_sharded_fn`` over NCCL, and ``zeroshot --num-devices <cards>
    --tp <cards>`` in each rank; (c) ``serve --num-devices <cards>`` over a
    group (torchrun), both towers. Returns the launches by path (``path@rankN``
    for the ranks)."""
    import os

    import torch

    t_phase = time.perf_counter()
    print("phase 16 (a): the shares of a tensor-parallel layer, one after another on this card")
    tp_heads16(mods, dev, seed, results)
    by_path = tp_layers16(_build, mods, dev, seed, results)
    print(f"phase 16 (a) took {time.perf_counter() - t_phase:.1f} s")
    world = torch.cuda.device_count()
    w = f"{workdir}/phase16"
    os.makedirs(w, exist_ok=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", str(ROOT / "chip_smoke.py"), "--phase16-rank", w,
           "--seed", str(seed)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=TP_TIMEOUT)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"phase 16's ranks ran past {TP_TIMEOUT} s: "
                           f"{(exc.stdout or '')[-3000:]}")
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"phase 16's torchrun exited with {proc.returncode}")
    for r in range(world):
        with open(f"{w}/rank{r}.json") as f:
            out = json.load(f)
        check(out["ok"], f"phase 16, rank {r} did not finish")
        for path, launches in out["launches"].items():
            check_launched(mods, launches, path)
            by_path[f"{path}@rank{r}"] = launches
        for name, v in out["results"].items():
            results.setdefault(name, {})["max_abs_err"] = max(
                v["max_abs_err"], results.get(name, {}).get("max_abs_err", 0.0))
    print(f"phase 16 (b): torchrun {time.perf_counter() - t0:.1f} s")
    by_path.update(tp_serve16(mods, dev, card, workdir, world))
    torch.cuda.empty_cache()
    print(f"phase 16 on {card}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def tp_serve16(mods, dev, card: str, workdir: str, world: int) -> dict:
    """Phase 16 (c): ``serve --num-devices <cards> --tp <cards>`` (the
    zero_shot preset) and ``serve --preset vit --fused-mlp --num-devices
    <cards>`` (B9 on each rank's data slice) over a group under torchrun,
    on phase 9's vocabulary and adapter checkpoint: rank 0 serves, the
    others follow its batches. TP_SERVE_WINDOWS windows of
    TP_SERVE_REQUESTS concurrent requests each, req/s their median,
    every answer 200 and equal across the bucket padding to the first
    answer to its image; SIGTERM stops every rank (rank 0 broadcasts the
    stop, each other rank reports it). Returns each server's launches by
    rank."""
    import os
    import signal
    import threading

    import numpy as np
    import torch

    kaggle, work9, work = f"{workdir}/kaggle", f"{workdir}/cli", f"{workdir}/phase16/serve"
    os.makedirs(work, exist_ok=True)
    image_dir = f"{kaggle}/images/images_normalized"
    pngs = []
    for n in sorted(os.listdir(image_dir)):
        with open(f"{image_dir}/{n}", "rb") as f:
            raw = f.read()
        if raw[:8] == b"\x89PNG\r\n\x1a\n":
            pngs.append(raw)
        if len(pngs) == 16:
            break
    script = f"{work}/serve_rank.py"
    with open(script, "w") as f:
        # a script's own directory heads sys.path, not the working directory
        f.write(f"import sys\nsys.path.insert(0, {str(ROOT)!r})\n")
        f.write(SERVE_CHILD.replace("path = sys.argv.pop(1)\n",
                                    "path = sys.argv.pop(1).format(rank=__import__('os')"
                                    ".environ.get('RANK', '0'))\n"))
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env.pop("CLIP_FOR_DL_TPU_FORCE_CPU", None)
    by_path = {}
    common = ["--vocab", f"{work9}/vocab.txt", "--flash-attention", "--bert-fused-mlp",
              "--host", "127.0.0.1", "--port", "0", "--buckets", "1", "8", "--num-devices",
              str(world)]
    runs = {"cli_group_serve": ["serve", "--checkpoint", f"{work9}/adapter", "--tp",
                                str(world)] + common,
            "cli_group_serve_vit": ["serve", "--preset", "vit", "--fused-mlp"] + common}
    launches = {path: f"{work}/launches_{path}_{{rank}}.json" for path in runs}
    served, failed = {}, []

    def start(path):  # both servers come up at once; the loads run in turn
        t0 = time.perf_counter()
        try:
            served[path] = (Served(runs[path] + ["--log-dir", f"{work}/{path}"],
                                   launches[path], env, ranks=world, script=script),
                            time.perf_counter() - t0)
        except Exception as exc:
            failed.append(exc)

    torch.cuda.synchronize(dev)
    starters = [threading.Thread(target=start, args=(path,)) for path in runs]
    for t in starters:
        t.start()
    for t in starters:
        t.join()
    stopped = {}
    try:
        if failed:
            raise failed[0]
        for path in runs:
            server, start_s = served[path]
            answers, rates = [], []
            for _ in range(TP_SERVE_WINDOWS):
                window = [None] * TP_SERVE_REQUESTS

                def client(c):
                    for k in range(c, TP_SERVE_REQUESTS, 8):
                        window[k] = server.request("POST", "/predict", pngs[k % len(pngs)])

                threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                rates.append(TP_SERVE_REQUESTS / (time.perf_counter() - t0))
                answers += window
            stats = server.request("GET", "/stats")[2]
            stopped[path] = server.stop(signal.SIGTERM)
            check_served16(mods, path, runs[path], server, answers, pngs, launches[path],
                           world, by_path)
            print(f"phase 16 (c): {' '.join(runs[path][:6])} ... over {world} rank(s) on "
                  f"{card}: up in {start_s:.1f} s (the two servers at once); "
                  f"{TP_SERVE_WINDOWS} windows of {TP_SERVE_REQUESTS} requests from 8 clients: "
                  f"median {float(np.median(rates)):.1f} req/s (windows "
                  f"{', '.join(f'{r:.1f}' for r in rates)}; batch "
                  f"sizes {stats['batch_size_hist']}; fetch {stats['fetch_ms']} ms); SIGTERM: "
                  f"torchrun exit {stopped[path]}; launches by rank "
                  f"{[by_path[f'{path}@rank{r}'] for r in range(world)]}")
    finally:
        for path, (server, _) in served.items():
            if path not in stopped:
                server.stop(signal.SIGTERM)
    return by_path


def check_served16(mods, path: str, argv, server, answers, pngs, launches: str, world: int,
                   by_path: dict) -> None:
    """Phase 16 (c)'s checks of one group server after its stop: every
    answer 200, an image's answers equal across batches within
    probs_vs_plain, rank 0's stop and each follower's report of it, and
    each rank's launches."""
    import numpy as np

    text = "".join(server.lines)
    check(all(a is not None and a[0] == 200 for a in answers),
          f"{path}: a request failed: {[a[:3] for a in answers if a and a[0] != 200][:3]}")
    probs = np.array([[a[2]["probs"][d] for d in sorted(a[2]["probs"])] for a in answers])
    first = {k % len(pngs): probs[k] for k in reversed(range(len(answers)))}
    spread = max(float(np.abs(probs[k] - first[k % len(pngs)]).max())
                 for k in range(len(answers)))
    check(spread <= TOL["probs_vs_plain"], f"{path}: one image's answers spread {spread}")
    check("shutting down" in text, f"{path}: rank 0 did not stop: {text[-2000:]}")
    followed = [line for line in text.splitlines() if "stopped by rank 0" in line]
    check(len(followed) == world - 1, f"{path}: {len(followed)} of {world - 1} ranks "
          f"reported rank 0's stop: {text[-2000:]}")
    for r in range(world):
        with open(launches.format(rank=r)) as f:
            by_path[f"{path}@rank{r}"] = json.load(f)
        check_launched(mods, by_path[f"{path}@rank{r}"], path)
    print(f"  {path}: every answer 200, one image's answers within {spread:.2e}; "
          f"{len(followed)} follower(s) stopped by rank 0")


def phase16_rank(w: str, seed: int) -> int:
    """One rank of phase 16 (``--phase16-rank W``, under torchrun): joins
    the NCCL group, loads the kernels the parent built, runs (b) and writes
    ``W/rank{r}.json``. Rank 0 prints."""
    import datetime
    import os

    import torch

    _build, mods = import_port()
    from clip_for_dl_tpu_torch.parallel import multihost

    dev = multihost.init_process_group(device="cuda",
                                       timeout=datetime.timedelta(seconds=DP_PG_TIMEOUT))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    out = {"ok": False, "launches": {}, "results": {}}
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        _build.build()
        degrees = [t for t in (2, 4) if world % t == 0] or [1]
        print(f"phase 16 (b): world size {world} over NCCL; tp {degrees}")
        tp_engine16(_build, mods, dev, seed, degrees, out)
        tp_step16(_build, mods, dev, seed, degrees, out)
        tp_sp16(_build, mods, dev, seed, degrees, out)
        tp_cli16(_build, mods, dev, w, degrees, out)
        out["ok"] = True
    finally:
        with open(f"{w}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        multihost.destroy()
    return 0


def _peak_mib(dev) -> float:
    """The largest peak of device memory over the group's cards, MiB."""
    import torch
    import torch.distributed as dist

    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    return float(peak) / 2 ** 20


def tp_engine16(_build, mods, dev, seed: int, degrees, out: dict) -> None:
    """Phase 16 (b): the zero-shot engine (ResNet-50 + BERT-base, bf16, B3,
    B4, B2, B1) over the group data-parallel and at each tp degree, against
    the single-device engine on this rank from the same weights: the
    probabilities within TOL["eval_vs_plain"] (at tp 1 the TP layers' own
    path, bit for bit the plain engine's); the bank encode's ms, images/s
    (the median of TP_ZS_WINDOWS windows of TP_ZS_BATCHES batches of BATCH
    images, and their spread) and the peak memory on the
    card of each."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS
    from clip_for_dl_tpu_torch.parallel import tp
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, grey_images
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    prompts = prompts_for_family("prediction", DISEASE_LABELS)
    images = grey_images(np.random.default_rng(seed + 16), BATCH)
    cfg, plain = build_engine(dev, seed, "serve")
    plain.build_text_features(prompts)
    want = plain.probs(images)
    world = dist.get_world_size()
    layouts = [("dp", None)] * (world > 1) + [(f"tp{t}", t) for t in degrees]
    for name, t in layouts:
        cfg, single = build_engine(dev, seed, "serve")
        model = single.model
        if t is None:
            kw = {"group": dist.group.WORLD}
        else:
            mesh = tp.create_dp_tp_mesh(t)
            if t == 1:  # the TP layers' path with identity collectives
                tp.tensor_parallel_(model, mesh)
            kw = {"mesh": mesh}
        which = dict.fromkeys(("similarity", "image_prep", "flash_attention", "mlp"))
        stack, kept = first_inputs(mods, which)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        with stack:
            engine = ZeroShotEngine(model, single.tokenizer, DISEASE_LABELS, single.config,
                                    single.mean, single.std, single.image_size,
                                    single.max_text_length, single.compute_dtype, **kw)
            bank_ms = []
            for _ in range(2):  # the first also sets up the subgroups' communicators
                dist.barrier()
                t0 = time.perf_counter()
                engine.build_text_features(prompts)
                torch.cuda.synchronize(dev)
                bank_ms.append((time.perf_counter() - t0) * 1e3)
            got = engine.probs(images)
            torch.cuda.synchronize(dev)
        path = f"tp_engine_{name}"
        out["launches"][path] = dict(_build.LAUNCHES)
        err = float(np.abs(got - want).max())
        if t == 1:
            check(np.array_equal(got, want), f"{path}: the TP path at tp 1 differs from plain")
        check(err <= TOL["eval_vs_plain"], f"{path}: probabilities {err} from the plain engine's")
        rates = []
        for _ in range(TP_ZS_WINDOWS):
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(TP_ZS_BATCHES):
                engine.logits(images)
            torch.cuda.synchronize(dev)
            rates.append(TP_ZS_BATCHES * BATCH / (time.perf_counter() - t0))
        peak = _peak_mib(dev)
        print(f"phase 16 (b) engine {name} over {world} rank(s) ({describe(cfg)}): the bank "
              f"{bank_ms[1]:.1f} ms (the first {bank_ms[0]:.1f}); median "
              f"{float(np.median(rates)):.1f} images/s (windows "
              f"{', '.join(f'{r:.1f}' for r in rates)}, each {TP_ZS_BATCHES} x {BATCH} "
              f"512x512 grey); "
              f"peak {peak:.0f} MiB on the fullest card; probabilities {err:.3e} from "
              f"the single-device engine's; launches {out['launches'][path]}")
        hold_first_inputs(mods, kept, which, path, out["results"])
        del engine, single, model
        torch.cuda.empty_cache()


def tp_step16(_build, mods, dev, seed: int, degrees, out: dict) -> None:
    """Phase 16 (b): the phase-A step (ResNet-50 + BERT-base, dropout 0) at
    a global batch of TP_STEP_BATCH through ``tensor_parallel_step`` at each
    tp degree. On the fp32 route against the single-device step on this
    rank from the same weights, at phase 15's dp_bn fp32 bounds (the loss,
    each group's gradient, the shards gathered over the model group). In
    bf16 against the data-parallel step over the same data group (the same
    BatchNorm arithmetic and rows, the towers whole), so that only the
    shares' partial sums differ: the loss within train_loss_rel, each
    kernel held at its first inputs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.parallel import tp
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    batch = train_batch(np.random.default_rng(seed + 161), tokenizer(), dev, TP_STEP_BATCH,
                        TRAIN_LEN)

    def run(t, compute, shard=True):
        """(loss, group gradients, groups, config) of one step: single-device
        without ``t``; else over the ``t`` layout, the towers tensor-parallel
        or, without ``shard``, whole (data-parallel over its data group)."""
        preset, cfg, model = train_model(dev, seed, "pretrain_clip", compute)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        groups = [g.name for g in preset.train.groups]
        label_fn = make_label_fn(groups)
        gen = torch.Generator(dev).manual_seed(seed)
        if t is None:
            opt, step = pretrain_step(model, preset, cfg, compute)
            state, m = step(TrainState(model, opt), batch, base_lrs(preset), gen)
            return float(m["loss"]), group_grads(model, label_fn), groups, cfg
        mesh = tp.create_dp_tp_mesh(t)
        kw = tp.step_groups(mesh) if shard else {"group": mesh.data_group}
        opt, step = pretrain_step(model, preset, cfg, compute, **kw)
        state = TrainState(model, opt)
        if shard:
            state = tp.shard_state_tp(state, mesh)
        step = tp.tensor_parallel_step(step, mesh)
        state, m = step(state, batch, base_lrs(preset), mesh.generator(seed, dev))
        return float(m["loss"]), gathered_group_grads(model, label_fn, mesh), groups, cfg

    for t in degrees:
        with fp32_exact():
            loss, grads, groups, cfg = run(None, torch.float32)
            tloss, tgrads, _, _ = run(t, torch.float32)
        rel, cos = TOL["dp_bn"]["fp32"]
        print(f"phase 16 (b) step, fp32 route, tp {t} over {dist.get_world_size()} rank(s), "
              f"global batch {TP_STEP_BATCH}, {describe(cfg)}: loss {tloss:.6f} against "
              f"{loss:.6f} on one card")
        check(abs(tloss - loss) <= rel * abs(loss), f"tp {t}: the fp32 step's loss differs")
        compare_groups(f"phase 16 tp {t}", tgrads, grads, groups,
                       {g: cos.get(g, TOL["fp32_grad_cos"]) for g in groups})
        which = dict.fromkeys(TRAIN_KERNELS)
        stack, kept = first_inputs(mods, which)
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        with stack:
            tloss, _, _, _ = run(t, torch.bfloat16)
        torch.cuda.synchronize(dev)
        path = f"tp_step_{t}"
        out["launches"][path] = dict(_build.LAUNCHES)
        loss, _, _, _ = run(t, torch.bfloat16, shard=False)
        rel = TOL["train_loss_rel"]
        print(f"  bf16 step: loss {tloss:.6f} against the data-parallel step's {loss:.6f} over "
              f"the same data group (tol {rel} relative); launches {out['launches'][path]}")
        check(abs(tloss - loss) <= rel * abs(loss), f"tp {t}: the bf16 step's loss differs")
        hold_first_inputs(mods, kept, which, path, out["results"])
        torch.cuda.empty_cache()


def gathered_group_grads(model, label_fn, mesh) -> dict:
    """group_grads of a tensor-parallel model: each sharded parameter's
    gradient gathered over the model group into the whole one."""
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.parallel import tp

    parts: dict = {}
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        spec = getattr(p, "tp_spec", None)
        if spec is not None and mesh.model_size > 1:
            shards = [torch.empty_like(g) for _ in range(mesh.model_size)]
            dist.all_gather(shards, g.contiguous(), group=mesh.model_group)
            g = tp.gather_tensor(shards, spec)
        label = name if name in CALIBRATION else label_fn(tuple(name.split(".")))
        parts.setdefault(label, []).append(g.float().flatten())
    return {k: torch.cat(v) for k, v in parts.items()}


def tp_sp16(_build, mods, dev, seed: int, degrees, out: dict) -> None:
    """Phase 16 (b): ``sequence_sharded_fn`` of the BERT-base text tower
    (bf16, B3 over the gathered sequence, B4 on the local rows) at each
    degree, replicated and with ``tp_params``, against the tower's plain
    forward on this rank: the CLS's unit projected features within
    TOL["eval_text_features"] (replicated at one rank: bit for bit)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.ops.similarity import l2_normalize
    from clip_for_dl_tpu_torch.parallel.sp import sequence_sharded_fn
    from clip_for_dl_tpu_torch.parallel.tp import create_dp_tp_mesh
    from clip_for_dl_tpu_torch.tools.main_paths import build_engine, tokenizer, train_batch

    cfg, engine = build_engine(dev, seed, "serve")
    model = engine.model.eval()
    batch = train_batch(np.random.default_rng(seed + 162), tokenizer(), dev, TP_STEP_BATCH,
                        TRAIN_LEN)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    unit = lambda h: l2_normalize(model.text_projector(h[:, 0]).float())
    with torch.inference_mode():
        plain_h = model.text_tower(ids, mask)
        want = unit(plain_h)
    for t in degrees:
        mesh = create_dp_tp_mesh(t)
        for tp_params in (False, True):
            which = dict.fromkeys(("flash_attention", "mlp"))
            stack, kept = first_inputs(mods, which)
            torch.cuda.synchronize(dev)
            _build.reset_launches()
            with stack, torch.inference_mode():
                h = sequence_sharded_fn(model.text_tower, mesh, tp_params=tp_params)(ids, mask)
            torch.cuda.synchronize(dev)
            path = f"sp_text{'_tp' if tp_params else ''}_{t}"
            out["launches"][path] = dict(_build.LAUNCHES)
            with torch.inference_mode():
                err = float((unit(h) - want).abs().max())
            if t == 1 and not tp_params:
                check(torch.equal(h, plain_h), f"{path}: one rank's SP differs from plain")
            check(err <= TOL["eval_text_features"], f"{path}: unit features {err} from plain")
            print(f"phase 16 (b) {path}: [{TP_STEP_BATCH}, {TRAIN_LEN}] tokens over "
                  f"{dist.get_world_size()} rank(s) (sequence over {t}); unit text features "
                  f"{err:.3e} from the tower's plain forward; launches {out['launches'][path]}")
            hold_first_inputs(mods, kept, which, path, out["results"])
    del engine, model
    torch.cuda.empty_cache()


def tp_cli16(_build, mods, dev, w: str, degrees, out: dict) -> None:
    """Phase 16 (b): ``zeroshot --num-devices <world> --tp <t>`` on phase 9's
    files and adapter checkpoint in this rank of the group (path
    cli_tp_zeroshot), B2, B3, B4 and B1 held at their first inputs."""
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    workdir = os.path.dirname(w)
    work, kaggle = f"{workdir}/cli", f"{workdir}/kaggle"
    t = max(degrees)
    argv = ["zeroshot", "--reports-csv", f"{work}/labeled.csv", "--projections-csv",
            f"{kaggle}/indiana_projections.csv", "--image-dir",
            f"{kaggle}/images/images_normalized", "--image-cache", f"{work}/cache", "--vocab",
            f"{work}/vocab.txt", "--flash-attention", "--bert-fused-mlp", "--checkpoint",
            f"{work}/adapter", "--num-devices", str(dist.get_world_size()), "--tp", str(t),
            "--log-dir", f"{w}/zs_tp"]
    which = dict.fromkeys(("similarity", "image_prep", "flash_attention", "mlp"))
    stack, kept = first_inputs(mods, which)
    text = io.StringIO()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with stack, redirect_stdout(text):
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    check(rc == 0, f"phase 16 (b): zeroshot --tp {t} exited with {rc}: {text.getvalue()[-2000:]}")
    out["launches"]["cli_tp_zeroshot"] = dict(_build.LAUNCHES)
    print(f"phase 16 (b): zeroshot --num-devices {dist.get_world_size()} --tp {t}: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; launches {out['launches']['cli_tp_zeroshot']}")
    hold_first_inputs(mods, kept, which, "cli_tp_zeroshot", out["results"])
    torch.cuda.empty_cache()



# -- phase 17: the Switch-MoE text tower, routing over a group, expert parallelism ---------

MOE_EXPERTS = 8  # every other BERT-base layer's MLP routed over 8 experts (capacity 1.25)
MOE_STEPS = 10  # phase 17 (b)'s synced steps at TRAIN_BATCH (the first not counted)
MOE_CLI_BATCH = 16  # phase 17 (c) and (d)'s pretrain batch: two steps of 32 synthetic pairs
MOE_EP_STEPS = 4  # phase 17 (d)'s timed steps of each route (the first not counted)
MOE_TIMEOUT = 420  # seconds phase 17's torchrun may take, the build's load included
# phase 17 (b)'s prediction of its peak, written before its first run: phase 4's
# 18.5 GiB and 198 M more fp32 master parameters at 16 B each (the weights, two
# AdamW moments and the gradient)
MOE_PEAK_PREDICTED_GIB = 18.5 + 198e6 * 16 / 2 ** 30


def moe_phase17(_build, mods, dev, seed: int, card: str, workdir: str, results: dict,
                readings: dict) -> dict:
    """Phase 17: (a) one MoE layer and its ep shares on this card; (b) the
    phase-A step with the MoE text tower; (c) ``pretrain`` and ``zeroshot``
    with ``--moe-experts``; (d) ``torchrun --nproc-per-node <cards>
    chip_smoke.py --phase17-rank DIR``: ``pretrain --num-devices <cards>
    --moe-experts`` against one card, and the ``--ep`` steps against the
    data-parallel step. Returns the launches by path."""
    import os

    import torch

    t_phase = time.perf_counter()
    moe_layer17(dev, seed, card)
    by_path = {"moe_train": moe_step17(_build, mods, dev, seed, card, results, readings)}
    by_path.update(moe_cli17(_build, mods, dev, card, workdir, results))
    world = torch.cuda.device_count()
    w = f"{workdir}/phase17"
    os.makedirs(w, exist_ok=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", str(ROOT / "chip_smoke.py"), "--phase17-rank", w,
           "--seed", str(seed)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=MOE_TIMEOUT)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"phase 17's ranks ran past {MOE_TIMEOUT} s: "
                           f"{(exc.stdout or '')[-3000:]}")
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"phase 17's torchrun exited with {proc.returncode}")
    for r in range(world):
        with open(f"{w}/rank{r}.json") as f:
            out = json.load(f)
        check(out["ok"], f"phase 17, rank {r} did not finish")
        for path, launches in out["launches"].items():
            check_launched(mods, launches, path)
            by_path[f"{path}@rank{r}"] = launches
        for name, v in out["results"].items():
            results.setdefault(name, {})["max_abs_err"] = max(
                v["max_abs_err"], results.get(name, {}).get("max_abs_err", 0.0))
    print(f"phase 17 (d): torchrun {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    print(f"phase 17 on {card}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def experts_loop(self, xf, slot, cap):
    """Test-only: ``SwitchMoEMLP.experts`` as a loop of per-expert products
    (each a batch of one), the formulation phase 17 times beside the
    batched one the layer runs."""
    import torch
    import torch.nn.functional as F

    from clip_for_dl_tpu_torch.models import moe

    e_loc, d = self.wi.shape[0], xf.shape[1]
    local = slot - self.ep.rank * e_loc * cap
    local = torch.where((local >= 0) & (local < e_loc * cap), local, e_loc * cap)
    xin = moe.copy_to_model(xf, self.ep.group)
    xe = xin.new_zeros(e_loc * cap + 1, d).index_add(0, local, xin)
    wi, wo = self.wi.to(xf.dtype), self.wo.to(xf.dtype)
    ys = []
    for j in range(e_loc):
        h = moe._ExpertMatmul.apply(xe[None, j * cap:(j + 1) * cap], wi[j:j + 1])[0]
        h = F.gelu(h + self.bi[j].float()).to(xf.dtype)
        ys.append(moe._ExpertMatmul.apply(h[None], wo[j:j + 1])[0] + self.bo[j].float())
    ys.append(xf.new_zeros((1, d), dtype=torch.float32))
    return moe.reduce_from_model(torch.cat(ys)[local], self.ep.group)


def moe_products_reference(layer, x, r):
    """Test-only: the bf16 MoE layer's experts times the gate, before the
    final cast, in fp32 on its bf16 operands: for each expert the tokens
    ``r`` kept for it, x and wi, wo as bf16 values widened, the hidden
    rounded to bf16 between the products; TF32 off (``fp32_exact``)."""
    import torch
    import torch.nn.functional as F

    xf = x.reshape(-1, x.shape[-1]).float()
    out = torch.zeros_like(xf)
    cap = r.capacity
    for e in range(layer.num_experts):
        rows = torch.nonzero((r.slot >= e * cap) & (r.slot < (e + 1) * cap)).flatten()
        h = xf[rows] @ layer.wi[e].float() + layer.bi[e].float()
        h = F.gelu(h).to(torch.bfloat16).float()
        out[rows] = (h @ layer.wo[e].float() + layer.bo[e].float()) * r.gate[rows, None]
    return out


def moe_layer17(dev, seed: int, card: str) -> dict:
    """Phase 17 (a): one MoE layer at BERT-base width (768 -> 3072, 8
    experts, capacity 1.25) on TRAIN_BATCH reports of TRAIN_LEN tokens with
    their real padding: the bf16 layer (fp32 masters cast in the forward,
    as the train step runs it) against the fp32 route on the same input
    (TOL moe_bf16_rel of the output's largest entry); each expert product,
    forward and backward, against the fp32 product of its operands (TOL
    moe_product_rel) and its experts before the final cast against an
    fp32 reference on its bf16 operands (TOL moe_products_rel), and a
    planted fault, the products rounded to bf16, that must fail both; every ep share (2, 4, 8) run in this process
    and summed, against the unsharded bf16 layer: the output, the aux loss
    and every gradient bit for bit; the same for the per-expert loop
    (``experts_loop``, printed); the forward and backward time of the
    batched products and of the loop; the tokens routed and dropped by
    each expert, and the aux loss. Returns the two times (ms)."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.config import get_preset
    from clip_for_dl_tpu_torch.core.device import cast_in_forward, plain_name
    from clip_for_dl_tpu_torch.models import moe
    from clip_for_dl_tpu_torch.models.moe import (
        ExpertShard, SwitchMoEMLP, moe_shares, route, routing,
    )
    from clip_for_dl_tpu_torch.parallel.ep import shard_experts_
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.tools.main_paths import tokenizer, train_batch

    t0 = time.perf_counter()
    cfg = get_preset("pretrain_clip").model
    d, f = cfg.text_embedding_dim, cfg.text_intermediate_dim
    mask = train_batch(np.random.default_rng(seed + 171), tokenizer(), dev, TRAIN_BATCH,
                       TRAIN_LEN)["attention_mask"]
    g = torch.Generator(dev).manual_seed(seed + 172)
    with torch.device(dev):
        layer = SwitchMoEMLP(d, f, MOE_EXPERTS, cfg.moe_capacity_factor)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.02, generator=g)
    x = torch.randn(TRAIN_BATCH, TRAIN_LEN, d, device=dev, generator=g).to(torch.bfloat16)
    cot = torch.randn(TRAIN_BATCH, TRAIN_LEN, d, device=dev, generator=g)
    bf16 = cast_in_forward(copy.deepcopy(layer), torch.bfloat16)

    r = route(layer, x, mask)
    real = mask.reshape(-1) > 0
    kept = r.slot < MOE_EXPERTS * r.capacity
    routed = torch.bincount(r.expert[real], minlength=MOE_EXPERTS).tolist()
    dropped = torch.bincount(r.expert[real & ~kept], minlength=MOE_EXPERTS).tolist()
    print(f"phase 17 (a): MoE layer {d} -> {f}, {MOE_EXPERTS} experts, capacity "
          f"{cfg.moe_capacity_factor} x {TRAIN_BATCH * TRAIN_LEN} tokens / {MOE_EXPERTS} = "
          f"{r.capacity} slots an expert; {int(real.sum())} real tokens; routed per expert "
          f"{routed}, dropped {dropped}; aux loss {float(r.aux.detach()):.6f}")
    with torch.no_grad(), fp32_exact():
        y32 = layer(x.float(), mask)
        y16 = bf16(x, mask)
    err = float((y16.float() - y32).abs().max()) / float(y32.abs().max())
    print(f"  bf16 layer against the fp32 route: max |difference| {err:.3e} of the largest "
          f"entry {float(y32.abs().max()):.4f} (tol {TOL['moe_bf16_rel']:.3e})")
    check(err <= TOL["moe_bf16_rel"], "the bf16 MoE layer differs from the fp32 route")

    def products():
        """(the experts before the final cast against moe_products_reference,
        the worst of the layer's expert products, forward and backward,
        against fp32 products of their operands), relative to the largest
        entries."""
        calls, product = [], moe._bmm32

        def recording(a, b):
            calls.append((a, b, product(a, b)))
            return calls[-1][2]

        r16 = route(bf16, x, mask)
        xt = x.clone().requires_grad_()
        with fp32_exact(), mock.patch.object(moe, "_bmm32", recording):
            got = bf16.experts(xt.reshape(-1, d), r16.slot, r16.capacity) * r16.gate[:, None]
            got.backward(cot.reshape(-1, d))
        with torch.no_grad(), fp32_exact():
            want = moe_products_reference(bf16, x, r16)
            each = []
            for a, b, out in calls:
                exact = torch.bmm(a.float(), b.float())
                each.append(float((out - exact).abs().max()) / float(exact.abs().max()))
        bf16.zero_grad(set_to_none=True)
        return float((got.detach() - want).abs().max()) / float(want.abs().max()), max(each)

    err, each = products()
    real_bmm = moe._bmm32
    with mock.patch.object(moe, "_bmm32",
                           lambda a, b: real_bmm(a, b).to(torch.bfloat16).float()):
        fault, fault_each = products()
    bound, bound_each = TOL["moe_products_rel"], TOL["moe_product_rel"]
    print(f"  the bf16 layer's expert products (forward and backward) against fp32 products of "
          f"their operands: at most {each:.3e} of the largest entry (tol {bound_each:.3e}); "
          f"its experts before the final cast against fp32 on its bf16 operands: {err:.3e} "
          f"(tol {bound:.3e}); the planted fault (products rounded to bf16): {fault_each:.3e} "
          f"and {fault:.3e}")
    check(each <= bound_each and err <= bound,
          "the bf16 MoE layer's products do not keep fp32 outputs")
    check(fault_each > bound_each and fault > bound,
          "the planted fault (bf16 products) passes the products' bounds")

    def run(shares):
        for s in shares:
            s.zero_grad(set_to_none=True)
        xt = x.clone().requires_grad_()
        with routing() as aux:
            y = moe_shares(shares, xt, mask)
        ((y.float() * cot).sum() + aux[0]).backward()
        grads: dict = {}
        for s in shares:
            for n, p in s.named_parameters():
                if p.grad is not None:
                    grads.setdefault(plain_name(f"moe_mlp.{n}"), []).append(p.grad)
        return y, aux[0].detach(), xt.grad, {k: torch.cat(v) for k, v in grads.items()}

    times = {}
    for form, experts in (("batched", SwitchMoEMLP.experts), ("loop", experts_loop)):
        with mock.patch.object(SwitchMoEMLP, "experts", experts):
            want = run([bf16])
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            for _ in range(5):
                run([bf16])
            torch.cuda.synchronize(dev)
            times[form] = (time.perf_counter() - t) / 5 * 1e3
            for e in (t for t in (2, 4, 8) if MOE_EXPERTS % t == 0):
                shares = [shard_experts_(copy.deepcopy(bf16), ExpertShard(k, e))
                          for k in range(e)]
                got = run(shares)
                same = {"output": torch.equal(got[0], want[0]),
                        "aux": torch.equal(got[1], want[1]), "x": torch.equal(got[2], want[2])}
                same.update({k: torch.equal(got[3][k], want[3][k]) for k in want[3]})
                print(f"  {form} products, ep {e}: {e} shares of {MOE_EXPERTS // e} experts "
                      f"summed, against the unsharded layer bit for bit: {same}")
                if form == "batched":  # the layer's own products
                    check(all(same.values()) and set(got[3]) == set(want[3]),
                          f"ep {e}: the shares' sum differs from the unsharded layer")
                del shares, got
    print(f"  the bf16 layer's forward and backward on {card}: {times['batched']:.2f} ms with "
          f"one batched product over the experts, {times['loop']:.2f} ms with a product an "
          f"expert")
    print(f"phase 17 (a) took {time.perf_counter() - t0:.1f} s")
    return times


def moe_step17(_build, mods, dev, seed: int, card: str, results: dict, readings: dict) -> dict:
    """Phase 17 (b): pretrain_clip's step with the MoE text tower (8
    experts in layers 1, 3, ..., 11) at TRAIN_BATCH on phase 4's batch:
    the first step against the plain route from the same weights, dropout
    0 (phase 4's bounds); then MOE_STEPS synced steps (path moe_train),
    samples/s and peak memory beside phase 4's dense step, the launches a
    step of each kernel, each held at its first inputs."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    preset, cfg, model = train_model(dev, seed, "pretrain_clip", text_moe_experts=MOE_EXPERTS)
    groups = [g.name for g in preset.train.groups]
    lrs, label_fn = base_lrs(preset), make_label_fn(groups)
    batch = train_batch(np.random.default_rng(seed + 2), tokenizer(), dev, TRAIN_BATCH,
                        TRAIN_LEN)
    n = sum(p.numel() for p in model.parameters())
    moe = [i for i, layer in enumerate(model.text_tower.encoder.layer)
           if hasattr(layer, "moe_mlp")]
    print(f"phase 17 (b): {describe(cfg)} with {MOE_EXPERTS} experts in layers {moe}: "
          f"{n / 1e6:.1f} M fp32 master parameters, built in {time.perf_counter() - t0:.1f} s")
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def fresh(dropout: float):
        model.load_state_dict(init)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = dropout
        opt, step = pretrain_step(model, preset, cfg)
        return TrainState(model, opt), step

    def one_step():
        state, step = fresh(0.0)
        loss = float(step(state, batch, lrs)[1]["loss"])
        return loss, group_grads(model, label_fn)

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        loss_k, grads_k = one_step()
        with plain_kernels(mods, keep=("image_prep",)):
            before = dict(_build.LAUNCHES)
            loss_p, grads_p = one_step()
            check(all(v == before.get(k) for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL),
                  "a kernel other than B2 ran during the plain MoE step")
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  first step, dropout 0: loss {loss_k:.6f} with the kernels, {loss_p:.6f} with the "
          f"plain versions (rel {loss_err:.2e}, tol {TOL['train_loss_rel']:.0e})")
    check(loss_err <= TOL["train_loss_rel"], "the MoE step's loss differs from the plain step's")
    compare_groups("the MoE step", grads_k, grads_p, groups, TOL["grad_cos"])
    del grads_k, grads_p

    state, step = fresh(cfg.dropout)
    which = dict.fromkeys(TRAIN_KERNELS)
    stack, kept = first_inputs(mods, which)
    gen = torch.Generator(dev).manual_seed(seed)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, times = [], []
    with stack:
        for i in range(MOE_STEPS):
            t = time.perf_counter()
            losses.append(float(step(state, batch, lrs, gen)[1]["loss"]))  # syncs the step
            times.append(time.perf_counter() - t)
    torch.cuda.synchronize(dev)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steady = times[1:]
    rate = TRAIN_BATCH * len(steady) / sum(steady)
    dense_rate, dense_peak = readings.get("train", (float("nan"), float("nan")))
    print(f"  losses {[round(v, 4) for v in losses]}")
    print(f"MoE train path on {card}: {rate:.1f} samples/s over steps 1-{MOE_STEPS - 1} "
          f"({1e3 * sum(steady) / len(steady):.1f} ms/step; step 0 {times[0] * 1e3:.1f} ms), "
          f"the dense step's {dense_rate:.1f} (phase 4); peak device memory {peak:.2f} GiB, "
          f"the dense step's {dense_peak:.2f}, predicted {MOE_PEAK_PREDICTED_GIB:.1f}")
    from clip_for_dl_tpu_torch.models.moe import SwitchMoEMLP

    loop_times = []
    with mock.patch.object(SwitchMoEMLP, "experts", experts_loop):
        for i in range(MOE_STEPS):
            t = time.perf_counter()
            float(step(state, batch, lrs, gen)[1]["loss"])  # syncs the step
            loop_times.append(time.perf_counter() - t)
    loop_rate = TRAIN_BATCH * (MOE_STEPS - 1) / sum(loop_times[1:])
    print(f"  the same step with a product an expert (experts_loop): {loop_rate:.1f} samples/s "
          f"over steps 1-{MOE_STEPS - 1}, against {rate:.1f} with one batched product")
    per_step = {name: launches.get(KERNELS[name][0], 0) / MOE_STEPS for name in TRAIN_KERNELS}
    print(f"  launches a step: {per_step}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"MoE losses {losses}")
    # B3 and B6 in every layer, B4 and B8 in the dense ones only
    want = {"flash_attention": cfg.text_layers, "flash_attention_bwd": cfg.text_layers,
            "mlp": cfg.text_layers - len(moe), "mlp_bwd": cfg.text_layers - len(moe)}
    check(all(per_step[k] == v for k, v in want.items()),
          f"the MoE step's launches a step: {per_step}, not {want}")
    hold_first_inputs(mods, kept, which, "moe_train", results)
    check_launched(mods, launches, "moe_train")
    readings["moe_train"] = (rate, peak)
    del state, step, model
    torch.cuda.empty_cache()
    return launches


def moe_zeroshot_argv(workdir: str, checkpoint: str, log_dir: str, experts: bool = True) -> list:
    """``zeroshot`` on phase 9's files from ``checkpoint``, with or without
    ``--moe-experts``."""
    argv = dp_zeroshot_argv(workdir, log_dir)
    argv[argv.index("--checkpoint") + 1] = checkpoint
    return argv + (["--moe-experts", str(MOE_EXPERTS)] if experts else [])


def moe_cli17(_build, mods, dev, card: str, workdir: str, results: dict) -> dict:
    """Phase 17 (c): ``pretrain --moe-experts 8`` at full width on phase
    9's vocabulary (two steps of MOE_CLI_BATCH synthetic pairs, a
    checkpoint; path cli_pretrain_moe), ``zeroshot --moe-experts 8`` of it
    on phase 9's files (path cli_zeroshot_moe), each kernel held at its
    first inputs; ``zeroshot`` without the flag raises in the missing-tensor
    guard (the command exits 1), naming the dense tensors the checkpoint
    lacks and the flag."""
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    w = f"{workdir}/phase17"
    os.makedirs(w, exist_ok=True)
    pretrain = ["pretrain", "--vocab", f"{workdir}/cli/vocab.txt", "--flash-attention",
                "--bert-fused-mlp", "--synthetic", "--synthetic-samples",
                str(2 * MOE_CLI_BATCH), "--batch-size", str(MOE_CLI_BATCH), "--epochs", "1",
                "--moe-experts", str(MOE_EXPERTS), "--checkpoint-dir", f"{w}/ckpt",
                "--log-dir", f"{w}/logs"]
    by_path = {}
    for path, argv, which in (
            ("cli_pretrain_moe", pretrain, TRAIN_KERNELS),
            ("cli_zeroshot_moe", moe_zeroshot_argv(workdir, f"{w}/ckpt", f"{w}/zs"),
             ("similarity", "image_prep", "flash_attention", "mlp"))):
        stack, kept = first_inputs(mods, dict.fromkeys(which))
        text = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        with stack, redirect_stdout(text):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        check(rc == 0, f"phase 17 (c): {argv[0]} exited with {rc}: {text.getvalue()[-2000:]}")
        by_path[path] = dict(_build.LAUNCHES)
        print(f"phase 17 (c): {argv[0]} --moe-experts {MOE_EXPERTS}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s on {card}; launches {by_path[path]}")
        check_launched(mods, by_path[path], path)
        hold_first_inputs(mods, kept, dict.fromkeys(which), path, results)
        torch.cuda.empty_cache()
    check(os.path.exists(f"{w}/zs/zero_shot_results.csv"), "zeroshot wrote no results")
    try:
        with redirect_stdout(io.StringIO()):
            cli.main(moe_zeroshot_argv(workdir, f"{w}/ckpt", f"{w}/zs_plain", experts=False))
        refused = None
    except ValueError as exc:
        refused = str(exc)
    print(f"  zeroshot without --moe-experts: {refused}")
    check(refused is not None and "layer.1.intermediate.dense" in refused
          and "--moe-experts" in refused, "zeroshot without --moe-experts was not refused")
    torch.cuda.empty_cache()
    return by_path


def phase17_rank(w: str, seed: int) -> int:
    """One rank of phase 17 (``--phase17-rank W``, under torchrun): joins
    the NCCL group, loads the kernels the parent built, runs (d) and writes
    ``W/rank{r}.json``. Rank 0 prints."""
    import datetime
    import os

    import torch

    _build, mods = import_port()
    from clip_for_dl_tpu_torch.parallel import multihost

    dev = multihost.init_process_group(device="cuda",
                                       timeout=datetime.timedelta(seconds=DP_PG_TIMEOUT))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    out = {"ok": False, "launches": {}, "results": {}}
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        _build.build()
        print(f"phase 17 (d): world size {world} over NCCL")
        ref = moe_dp17(_build, mods, dev, seed, w, out)
        degrees = [e for e in (2, 4, 8) if world % e == 0 and MOE_EXPERTS % e == 0]
        if degrees:
            moe_ep_cli17(_build, mods, dev, w, degrees[0], ref, out)
            moe_ep17(_build, mods, dev, seed, degrees, out)
        out["ok"] = True
    finally:
        with open(f"{w}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        multihost.destroy()
    return 0


def moe_dp17(_build, mods, dev, seed: int, w: str, out: dict) -> dict:
    """Phase 17 (d): ``pretrain --num-devices <cards> --moe-experts 8`` over
    the group (path cli_dp_pretrain_moe, each kernel held at its first
    inputs), its first step kept; then, from the weights and optimizer
    state it started from, dropout 0: that step on this rank's rows against
    the single-device step on the global batch (the ranks' rows gathered):
    in bf16 printed (the group's BatchNorm runs through the group at every
    world size, so no world size is bit for bit there, and at this batch
    its bf16 sums move the loss by a few percent), and on the fp32 route
    (the step rebuilt in fp32, fp32_compute) at TOL dp_bn fp32. Then the
    MoE text tower alone (the features and the gradient of a fixed
    cotangent, summed over the ranks, no BatchNorm on the way) routing over
    the group against one card routing the global batch: in bf16 printed
    with the tokens each MoE layer sends to another expert than one card
    does (bit for bit at world size 1); on the fp32 route at a capacity
    factor that drops tokens in every MoE layer (C half the real tokens'
    mean share an expert), at TOL moe_group_fp32_rel and
    fp32_grad_cos, and with more than one rank the planted fault (each rank
    routing its own rows alone) must fail that bound. Returns the fp32
    single-device step's loss and the global batch, the reference of the
    ``--ep`` command (moe_ep_cli17)."""
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.models import moe
    from clip_for_dl_tpu_torch.parallel.collectives import all_gather_rows
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.tools.main_paths import pretrain_step
    from clip_for_dl_tpu_torch.train import TrainState, loop, make_label_fn

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    group, world = dist.group.WORLD, dist.get_world_size()
    workdir = os.path.dirname(w)
    argv = ["pretrain", "--vocab", f"{workdir}/cli/vocab.txt", "--flash-attention",
            "--bert-fused-mlp", "--synthetic", "--synthetic-samples", str(2 * MOE_CLI_BATCH),
            "--batch-size", str(MOE_CLI_BATCH), "--epochs", "1", "--moe-experts",
            str(MOE_EXPERTS), "--num-devices", str(world), "--checkpoint-dir",
            f"{w}/ckpt_dp", "--log-dir", f"{w}/logs_dp"]
    first, run_epoch = {}, loop.run_epoch

    def kept_epoch(step_fn, state, loader, *a, **kw):
        def kept_step(st, batch, *rest):
            if not first:
                first.update(step=step_fn, state=st, rest=rest, batch={
                    k: v.clone() for k, v in batch.items() if torch.is_tensor(v)},
                    weights={k: v.detach().clone() for k, v in st.model.state_dict().items()},
                    optimizer=copy.deepcopy(st.optimizer.state_dict()))
            return step_fn(st, batch, *rest)

        return run_epoch(kept_step, state, loader, *a, **kw)

    path, which = "cli_dp_pretrain_moe", dict.fromkeys(TRAIN_KERNELS)
    stack, kept = first_inputs(mods, which)
    text = io.StringIO()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with stack, mock.patch.object(loop, "run_epoch", kept_epoch), redirect_stdout(text):
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    check(rc == 0, f"phase 17 (d): pretrain exited with {rc}: {text.getvalue()[-2000:]}")
    out["launches"][path] = dict(_build.LAUNCHES)
    print(f"phase 17 (d): pretrain --num-devices {world} --moe-experts {MOE_EXPERTS}: exit 0 "
          f"in {time.perf_counter() - t0:.1f} s; launches {out['launches'][path]}")
    hold_first_inputs(mods, kept, which, path, out["results"])

    model, opt = first["state"].model, first["state"].optimizer
    preset = cli._preset(argparse.Namespace(preset="pretrain_clip"))
    cfg = model.config
    groups = [g.name for g in preset.train.groups]
    label_fn = make_label_fn(groups)
    whole = {k: all_gather_rows(v, group) for k, v in first["batch"].items()}
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0

    def one(step, optimizer, batch):
        model.load_state_dict(first["weights"])
        optimizer.load_state_dict(first["optimizer"])
        state, metrics = step(TrainState(model, optimizer), batch, *first["rest"][:1])
        return float(metrics["loss"]), group_grads(model, label_fn)

    loss_g, _ = one(first["step"], opt, first["batch"])
    single_opt, single = pretrain_step(model, preset, cfg)
    loss_s, _ = one(single, single_opt, whole)
    print(f"  the command's first step over {world} rank(s), dropout 0, bf16: loss {loss_g:.6f} "
          f"against {loss_s:.6f} on one card on the global batch of {MOE_CLI_BATCH} (a reading: "
          f"BatchNorm's bf16 sums over the group against cuDNN's at this batch)")
    steps32 = [pretrain_step(model, preset, cfg, torch.float32, **kw) for kw in ({"group": group},
                                                                              {})]
    with fp32_compute(model), fp32_exact():
        loss_g, grads_g = one(steps32[0][1], steps32[0][0], first["batch"])
        loss_s, grads_s = one(steps32[1][1], steps32[1][0], whole)
    rel, cos = TOL["dp_bn"]["fp32"]
    print(f"  the same step on the fp32 route: loss {loss_g:.6f} over the group against "
          f"{loss_s:.6f} on one card (tol {rel} relative)")
    check(abs(loss_g - loss_s) <= rel * abs(loss_s), "the group's MoE step loss differs")
    compare_groups("phase 17 (d) group step", grads_g, grads_s, groups,
                   {g: cos.get(g, TOL["fp32_grad_cos"]) for g in groups})
    ref = {"loss": loss_s, "whole": whole}
    del grads_g, grads_s, steps32, single, single_opt

    # the text tower alone: routing over the group against routing the global batch
    model.load_state_dict(first["weights"])
    model.train()
    g = torch.Generator(dev).manual_seed(seed + 174)
    cot = torch.randn(MOE_CLI_BATCH, cfg.shared_embedding_dim, device=dev, generator=g)
    n = MOE_CLI_BATCH // world
    rows = slice(dist.get_rank() * n, (dist.get_rank() + 1) * n)
    text_params = [p for name, p in model.named_parameters() if name.startswith("text_tower.")]
    layers = [m for m in model.modules() if isinstance(m, moe.SwitchMoEMLP)]
    real = whole["attention_mask"] > 0
    real_route = moe.route

    def text(batch, cot_rows, over, aux_scale=1.0):
        """(features, the text tower's gradient, each MoE layer's [B, L]
        (expert, kept) choices); the aux losses weighted by aux_scale."""
        model.zero_grad(set_to_none=True)
        chosen = []

        def recording(layer, x, mask=None, group=None):
            r = real_route(layer, x, mask, group)
            kept = r.slot < layer.num_experts * r.capacity
            chosen.append((r.expert.view(x.shape[:2]), kept.view(x.shape[:2])))
            return r

        with mock.patch.object(moe, "route", recording), moe.routing(over) as aux:
            feats = model.encode_text(batch["input_ids"], batch["attention_mask"])
        ((feats.float() * cot_rows).sum() + aux_scale * sum(aux)).backward()
        grad = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).float().flatten()
                          for p in text_params])
        return feats.detach().float(), grad, chosen

    def against_one_card(over):
        """The group's rows routed over ``over`` (the group, or None: each
        rank alone) against one card on the global batch: (features' max
        difference over the largest entry, gradient cosine, bit for bit,
        tokens routed to another expert per layer, tokens dropped per layer
        on one card, tokens kept or dropped otherwise per layer). The
        group's aux losses count 1/world: by the all_reduce_sum convention
        each rank's aux gradient is world times its rows' share."""
        feats_g, grad_g, chosen_g = text(first["batch"], cot[rows], over, 1.0 / world)
        feats_s, grad_s, chosen_s = text(whole, cot, None)
        dist.all_reduce(grad_g, group=group)
        feats_g = all_gather_rows(feats_g, group)
        moved, dropped, kept_other = [], [], []
        for (e_g, k_g), (e_s, k_s) in zip(chosen_g, chosen_s):
            e_g, k_g = all_gather_rows(e_g, group), all_gather_rows(k_g, group)
            moved.append(int(((e_g != e_s) & real).sum()))
            dropped.append(int((~k_s & real).sum()))
            kept_other.append(int(((k_g != k_s) & real).sum()))
        diff = float((feats_g - feats_s).abs().max()) / float(feats_s.abs().max())
        same = torch.equal(feats_g, feats_s) and torch.equal(grad_g, grad_s)
        return diff, cosine(grad_g.double(), grad_s.double()), same, moved, dropped, kept_other

    diff, cos_t, same, moved, _, _ = against_one_card(group)
    print(f"  the MoE text tower in bf16 routing over the group against one card routing the "
          f"global batch: features max |difference| {diff:.3e} of the largest entry, gradient "
          f"cosine {cos_t:.6f}, bit for bit: {same}; real tokens routed to another expert, by "
          f"MoE layer: {moved} of {int(real.sum())}")
    if world == 1:
        check(same, "at world size 1 the group's MoE text tower is not the single card's")
    factors = [m.capacity_factor for m in layers]
    bound, cos_bound = TOL["moe_group_fp32_rel"], TOL["fp32_grad_cos"]
    # half the real tokens' mean share an expert: every layer drops tokens
    factor = 0.5 * float(real.sum()) / real.numel()
    try:
        for m in layers:
            m.capacity_factor = factor
        with fp32_compute(model), fp32_exact():
            diff, cos_t, _, moved, dropped, other = against_one_card(group)
            print(f"  the same on the fp32 route at capacity factor {factor:.4f}: tokens dropped "
                  f"by layer {dropped} of {int(real.sum())}; features {diff:.3e} of the largest "
                  f"entry (tol {bound:.0e}), gradient cosine {cos_t:.6f} (tol {cos_bound}); "
                  f"tokens routed elsewhere {moved}, kept or dropped otherwise {other}")
            check(all(dropped), f"capacity factor {factor}: a MoE layer dropped no token")
            check(diff <= bound and cos_t >= cos_bound,
                  "the MoE text tower routing over the group differs from one card")
            if world > 1:
                diff, cos_t, _, moved, _, other = against_one_card(None)
                print(f"  the planted fault, each rank routing its own rows alone: features "
                      f"{diff:.3e}, gradient cosine {cos_t:.6f}; tokens kept or dropped "
                      f"otherwise {other}")
                check(diff > bound or cos_t < cos_bound,
                      "the planted fault (per-rank routing) passes the group's bound")
    finally:
        for m, f in zip(layers, factors):
            m.capacity_factor = f
    torch.cuda.empty_cache()
    return ref


def moe_ep_cli17(_build, mods, dev, w: str, e: int, ref: dict, out: dict) -> None:
    """Phase 17 (d): ``pretrain --num-devices <cards> --ep e --moe-experts
    8 --fp32 --flash-attention`` (path cli_ep_pretrain_moe, each kernel held
    at its first inputs) with every preset's dropout at 0 (the rate has no
    flag), TF32 off: the rows each rank's first step takes are its data
    slice of the global batch the ``--num-devices`` command took (moe_dp17),
    the step's loss is the fp32 single-device step's on that batch from the
    same weights (TOL moe_ep_command_rel), and the checkpoint is whole: each expert
    tensor holds the 8 experts, the rank's own rows those it trained, the
    AdamW moments whole too."""
    import dataclasses
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.core import config
    from clip_for_dl_tpu_torch.core.device import plain_name
    from clip_for_dl_tpu_torch.parallel.ep import ep_spec
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.train import loop

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    world, rank = dist.get_world_size(), dist.get_rank()
    workdir = os.path.dirname(w)
    argv = ["pretrain", "--vocab", f"{workdir}/cli/vocab.txt", "--fp32", "--flash-attention",
            "--synthetic", "--synthetic-samples", str(2 * MOE_CLI_BATCH), "--batch-size",
            str(MOE_CLI_BATCH), "--epochs", "1", "--moe-experts", str(MOE_EXPERTS),
            "--num-devices", str(world), "--ep", str(e), "--checkpoint-dir", f"{w}/ckpt_ep",
            "--log-dir", f"{w}/logs_ep"]
    real_preset = config.get_preset

    def no_dropout(name):
        cfg = real_preset(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))

    first, run_epoch = {}, loop.run_epoch

    def kept_epoch(step_fn, state, loader, *a, **kw):
        def kept_step(st, batch, *rest):
            if first:
                return step_fn(st, batch, *rest)
            rows = {k: v.clone() for k, v in batch.items() if torch.is_tensor(v)}
            st, metrics = step_fn(st, batch, *rest)
            first.update(model=st.model, batch=rows, loss=float(metrics["loss"]))
            return st, metrics

        return run_epoch(kept_step, state, loader, *a, **kw)

    # the fp32 instances, which first_inputs keeps under their entries' names
    path, which = "cli_ep_pretrain_moe", dict.fromkeys(("image_prep", "flash_attention",
                                                        "flash_attention_bwd"))
    stack, kept = first_inputs(mods, which)
    text = io.StringIO()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with stack, fp32_exact(), mock.patch.object(config, "get_preset", no_dropout), \
            mock.patch.object(loop, "run_epoch", kept_epoch), redirect_stdout(text):
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    check(rc == 0, f"phase 17 (d): pretrain --ep {e} exited with {rc}: "
                   f"{text.getvalue()[-2000:]}")
    out["launches"][path] = dict(_build.LAUNCHES)
    print(f"phase 17 (d): pretrain --num-devices {world} --ep {e} --moe-experts {MOE_EXPERTS} "
          f"--fp32, dropout 0: exit 0 in {time.perf_counter() - t0:.1f} s; launches "
          f"{out['launches'][path]}")
    hold_first_inputs(mods, kept, which, path, out["results"])
    n, d = MOE_CLI_BATCH // (world // e), rank // e
    fed = {k: torch.equal(first["batch"][k], ref["whole"][k][d * n:(d + 1) * n])
           for k in ("input_ids", "attention_mask")}
    rel = TOL["moe_ep_command_rel"]
    print(f"  rank {rank}'s first rows are rows {d * n}-{(d + 1) * n - 1} of the global batch: "
          f"{fed}; first step's loss {first['loss']:.6f} against {ref['loss']:.6f} on one card "
          f"on the fp32 route (tol {rel} relative)")
    check(all(fed.values()), f"--ep {e}: rank {rank} was not fed its data slice")
    check(abs(first["loss"] - ref["loss"]) <= rel * abs(ref["loss"]),
          f"--ep {e}: the command's first step differs from one card's")
    saved = torch.load(f"{w}/ckpt_ep/0.pt", map_location="cpu", mmap=True, weights_only=False)
    k, i = MOE_EXPERTS // e, rank % e
    sharded = [(plain_name(name), p) for name, p in first["model"].named_parameters()
               if ep_spec(name).dim is not None]
    whole_rows = all(saved["model"][name].shape[0] == MOE_EXPERTS
                     and torch.equal(saved["model"][name][i * k:(i + 1) * k], p.detach().cpu())
                     for name, p in sharded)
    moments = {tuple(v.shape) for s in saved["optimizer"]["state"].values() for v in s.values()
               if torch.is_tensor(v) and v.dim() == 3}
    print(f"  the checkpoint: {len(sharded)} expert tensors of {MOE_EXPERTS} experts, this "
          f"rank's {k} its own: {whole_rows}; the moments' expert shapes {sorted(moments)}")
    check(sharded and whole_rows and all(s[0] == MOE_EXPERTS for s in moments),
          f"--ep {e}: the checkpoint is not the whole state")
    del saved, first
    torch.cuda.empty_cache()


def moe_ep17(_build, mods, dev, seed: int, degrees, out: dict) -> None:
    """Phase 17 (d): the phase-A step with the MoE text tower (dropout 0)
    at a global batch of DP_BATCH through ``expert_parallel_step`` at each
    ep degree, against the data-parallel step over every rank on the same
    batch: on the fp32 route at TOL dp_bn fp32 (the loss, each group's
    gradient, the expert shards gathered over the expert group); then each
    route's samples/s in bf16 over MOE_EP_STEPS steps (path ep_step_{e},
    each kernel held at its first inputs) and its peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.parallel import data_parallel_step, ep, tp
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    group, world = dist.group.WORLD, dist.get_world_size()
    batch = train_batch(np.random.default_rng(seed + 175), tokenizer(), dev, DP_BATCH,
                        TRAIN_LEN)

    def run(e, compute, steps=1):
        """(losses, the first step's group gradients, step seconds, config):
        over the (data, expert) layout at ep ``e``, or data-parallel over
        every rank without it."""
        preset, cfg, model = train_model(dev, seed, "pretrain_clip", compute,
                                         text_moe_experts=MOE_EXPERTS)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        label_fn = make_label_fn([g.name for g in preset.train.groups])
        if e is None:
            opt, step = pretrain_step(model, preset, cfg, compute, group=group)
            state, step = TrainState(model, opt), data_parallel_step(step, group)
            mesh, gen = None, torch.Generator(dev).manual_seed(seed + dist.get_rank())
        else:
            mesh = ep.create_dp_ep_mesh(e)
            opt, step = pretrain_step(model, preset, cfg, compute, **tp.step_groups(mesh))
            state = ep.shard_state_ep(TrainState(model, opt), mesh)
            step, gen = ep.expert_parallel_step(step, mesh), mesh.generator(seed, dev)
        losses, times, grads = [], [], None
        for i in range(steps):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            losses.append(float(step(state, batch, base_lrs(preset), gen)[1]["loss"]))
            times.append(time.perf_counter() - t)
            if i == 0:
                grads = (group_grads(model, label_fn) if mesh is None
                         else gathered_group_grads(model, label_fn, mesh))
        return losses, grads, times, cfg, [g.name for g in preset.train.groups]

    with fp32_exact():
        dp_losses, dp_grads, _, cfg, groups = run(None, torch.float32)
        for e in degrees:
            losses, grads, _, _, _ = run(e, torch.float32)
            rel, cos = TOL["dp_bn"]["fp32"]
            print(f"phase 17 (d) step, fp32 route, ep {e} ({world // e} x {e}), global batch "
                  f"{DP_BATCH}, {describe(cfg)} with {MOE_EXPERTS} experts: loss "
                  f"{losses[0]:.6f} against {dp_losses[0]:.6f} data-parallel")
            check(abs(losses[0] - dp_losses[0]) <= rel * abs(dp_losses[0]),
                  f"ep {e}: the fp32 step's loss differs from the data-parallel step's")
            compare_groups(f"phase 17 ep {e}", grads, dp_grads, groups,
                           {g: cos.get(g, TOL["fp32_grad_cos"]) for g in groups})
            torch.cuda.empty_cache()
    rates = {}
    for e in [None] + list(degrees):
        name = "dp" if e is None else f"ep {e}"
        which = dict.fromkeys(TRAIN_KERNELS)
        stack, kept = first_inputs(mods, which) if e is not None else (ExitStack(), None)
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        with stack:
            losses, _, times, _, _ = run(e, torch.bfloat16, MOE_EP_STEPS)
        torch.cuda.synchronize(dev)
        if e is not None:
            out["launches"][f"ep_step_{e}"] = dict(_build.LAUNCHES)
            hold_first_inputs(mods, kept, which, f"ep_step_{e}", out["results"])
        rates[name] = DP_BATCH * (len(times) - 1) / sum(times[1:])
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        print(f"  bf16 {name}: {rates[name]:.1f} samples/s over steps 1-{MOE_EP_STEPS - 1} "
              f"(global batch {DP_BATCH}); peak {_peak_mib(dev):.0f} MiB a card; losses "
              f"{[round(v, 4) for v in losses]}")
        torch.cuda.empty_cache()


PP_DEGREES = (2, 4)  # the stage counts phase 18 (a) runs on one card, (b) over the cards
PP_MICROBATCHES = 4
PP_CLI_BATCH = 16  # phase 18 (b)'s pretrain batch: two steps of 32 synthetic pairs
PP_STEPS = 4  # phase 18 (b)'s timed bf16 steps of each route (the first not counted)
PP_TIMEOUT = 420  # seconds phase 18's torchrun may take, the build's load included


def pp_phase18(_build, mods, dev, seed: int, card: str, workdir: str, results: dict) -> dict:
    """Phase 18: (a) every pipeline stage of a full-width BERT-base run one
    after another on this card (pp_shares18); (b) ``torchrun
    --nproc-per-node <cards> chip_smoke.py --phase18-rank DIR``
    (phase18_rank): the pipelined step over NCCL, and with more than one
    card ``pretrain --num-devices <cards> --pp 2`` and the steps at pp 2
    and 4 against the data-parallel step; then ``zeroshot --checkpoint
    DIR/ckpt_pp/unstacked`` on phase 9's files in this process (path
    cli_zeroshot_pp, B1-B4 held at their first inputs). Returns the
    launches by path."""
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import torch

    t_phase = time.perf_counter()
    pp_shares18(_build, dev, seed, card)
    world = torch.cuda.device_count()
    w = f"{workdir}/phase18"
    os.makedirs(w, exist_ok=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", str(ROOT / "chip_smoke.py"), "--phase18-rank", w,
           "--seed", str(seed)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=PP_TIMEOUT)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"phase 18's ranks ran past {PP_TIMEOUT} s: "
                           f"{(exc.stdout or '')[-3000:]}")
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"phase 18's torchrun exited with {proc.returncode}")
    by_path = {}
    for r in range(world):
        with open(f"{w}/rank{r}.json") as f:
            out = json.load(f)
        check(out["ok"], f"phase 18, rank {r} did not finish")
        for path, launches in out["launches"].items():
            check_launched(mods, launches, path)
            by_path[f"{path}@rank{r}"] = launches
        for name, v in out["results"].items():
            results.setdefault(name, {})["max_abs_err"] = max(
                v["max_abs_err"], results.get(name, {}).get("max_abs_err", 0.0))
    print(f"phase 18 (b): torchrun {time.perf_counter() - t0:.1f} s")

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    argv = moe_zeroshot_argv(workdir, f"{w}/ckpt_pp/unstacked", f"{w}/zs", experts=False)
    path, which = "cli_zeroshot_pp", dict.fromkeys(PATHS["cli_zeroshot_pp"])
    stack, kept = first_inputs(mods, which)
    text = io.StringIO()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    with stack, redirect_stdout(text):
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    check(rc == 0, f"phase 18: zeroshot of the unstacked checkpoint exited with {rc}: "
                   f"{text.getvalue()[-2000:]}")
    check(os.path.exists(f"{w}/zs/zero_shot_results.csv"), "zeroshot wrote no results")
    by_path[path] = dict(_build.LAUNCHES)
    print(f"phase 18: zeroshot --checkpoint {w}/ckpt_pp/unstacked: exit 0; launches "
          f"{by_path[path]}")
    check_launched(mods, by_path[path], path)
    hold_first_inputs(mods, kept, which, path, results)
    torch.cuda.empty_cache()
    print(f"phase 18 on {card}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def pp_groups(tower, shares=None) -> dict:
    """The gradients of a BERT tower by group: "stack" (every layer's, in
    layer order, from the share of its stage when ``shares`` are given) and
    "embeddings" (of the tower, or of each share as "embeddings@s")."""
    import torch

    def flat(params):
        return torch.cat([p.grad.float().flatten() for p in params])

    layers = list(tower.encoder.layer)
    if shares is None:
        return {"stack": flat([p for layer in layers for p in layer.parameters()]),
                "embeddings": flat(tower.embeddings.parameters())}
    lps = len(layers) // len(shares)
    out = {"stack": flat([p for i in range(len(layers))
                          for p in shares[i // lps].encoder.layer[i].parameters()])}
    out.update({f"embeddings@{s}": flat(sh.embeddings.parameters())
                for s, sh in enumerate(shares)})
    return out


def pp_shares18(_build, dev, seed: int, card: str) -> None:
    """Phase 18 (a): BERT-base at full width (12 layers, 768, 12 heads, MLP
    3072), built with flash attention and the fused MLP, which the pipeline
    ignores, on TRAIN_BATCH reports of TRAIN_LEN tokens with their padding:
    every stage's share run one after another on this card
    (``pipelined_bert_shares``) at S = 2 and 4, PP_MICROBATCHES
    microbatches, forward and backward of Σ out · cot, against the
    unpipelined tower on the plain routes, deterministic. On the fp32 route
    (TF32 off) the output within TOL pp_fp32_rel of its largest entry and
    each group's gradient (the stack; every share's embeddings) within it in
    norm, at cosine fp32_grad_cos; in bf16 (fp32 masters cast in the
    forward) at TOL pp_bf16. No kernel launches. The two planted faults at
    S = 2 on the fp32 route (the broadcast's summing backward: the stack's
    gradient S times; the embeddings' stage sum left out: share 1's
    embeddings without gradient) must each fail."""
    import copy

    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.core.device import cast_in_forward
    from clip_for_dl_tpu_torch.models import init_weights
    from clip_for_dl_tpu_torch.models.bert import BertEncoder
    from clip_for_dl_tpu_torch.parallel import pp
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact, pp_fault
    from clip_for_dl_tpu_torch.tools.main_paths import tokenizer, train_batch

    t0 = time.perf_counter()
    tok = tokenizer()
    batch = train_batch(np.random.default_rng(seed + 2), tok, dev, TRAIN_BATCH, TRAIN_LEN)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    with torch.device(dev):
        base = BertEncoder(vocab_size=len(tok.vocab), flash=True, fused_mlp=True)
    init_weights(base, torch.Generator(dev).manual_seed(seed + 18)).train()
    g = torch.Generator(dev).manual_seed(seed + 180)
    cot = torch.randn(TRAIN_BATCH, TRAIN_LEN, base.embeddings.word_embeddings.embedding_dim,
                      device=dev, generator=g)
    print(f"phase 18 (a): BERT {len(base.encoder.layer)} x {cot.shape[-1]} (flash and fused MLP "
          f"on) on {TRAIN_BATCH} reports of {TRAIN_LEN} tokens, {int(mask.sum())} of them real; "
          f"{PP_MICROBATCHES} microbatches")

    def run(tower, fn, fault=None):
        with pp_fault(fault):
            out = fn(tower)
            (out.float() * cot).sum().backward()
        return out.detach().float()

    def rel(a, b):
        return float((a - b).norm()) / float(b.norm())

    for route in ("fp32", "bf16"):
        dtype = torch.float32 if route == "fp32" else torch.bfloat16
        tower = copy.deepcopy(base) if route == "fp32" else cast_in_forward(
            copy.deepcopy(base), dtype)
        plain = copy.deepcopy(tower).eval()
        for m in plain.modules():
            for flag in ("flash", "fused_mlp"):
                if isinstance(getattr(m, flag, None), bool):
                    setattr(m, flag, False)
        bound = TOL["pp_fp32_rel"] if route == "fp32" else TOL["pp_bf16"]["rel"]
        cos_bound = TOL["fp32_grad_cos"] if route == "fp32" else TOL["pp_bf16"]["cos"]
        with fp32_exact():
            want = run(plain, lambda t: t(ids, mask))
            wgrads = pp_groups(plain)
            del plain
            cases = [(s, None) for s in PP_DEGREES]
            if route == "fp32":
                cases += [(2, fault) for fault in ("summing_broadcast", "no_stage_sum")]
            for s, fault in cases:
                shares = [pp.shard_stage_(copy.deepcopy(tower), k, s) for k in range(s)]
                torch.cuda.synchronize(dev)
                before, t = dict(_build.LAUNCHES), time.perf_counter()
                got = run(shares, lambda sh: pp.pipelined_bert_shares(sh, ids, mask,
                                                                      PP_MICROBATCHES), fault)
                torch.cuda.synchronize(dev)
                seconds = time.perf_counter() - t
                check(dict(_build.LAUNCHES) == before,
                      f"the pipelined tower launched a kernel: {dict(_build.LAUNCHES)}")
                out_err = float((got - want).abs().max()) / float(want.abs().max())
                grads = pp_groups(shares[0], shares)
                errs = {k: rel(v, wgrads[k.split("@")[0]]) for k, v in grads.items()}
                coss = {k: cosine(v, wgrads[k.split("@")[0]]) for k, v in grads.items()}
                worst = max(errs, key=errs.get)
                held = (out_err <= bound and max(errs.values()) <= bound
                        and min(coss.values()) >= cos_bound)
                what = f"S = {s}" + (f", planted fault {fault}" if fault else "")
                print(f"  {route}, {what}: output {out_err:.3e} of its largest entry; gradients "
                      f"{', '.join(f'{k} {errs[k]:.3e} (cos {coss[k]:.7f})' for k in errs)} "
                      f"(tol {bound:.0e}, cos {cos_bound}); worst {worst}; forward and backward "
                      f"{seconds * 1e3:.0f} ms; held: {held}")
                check(held == (fault is None),
                      f"phase 18 (a), {route} {what}: held {held}")
                del shares, got, grads
                torch.cuda.empty_cache()
        del tower, want, wgrads
        torch.cuda.empty_cache()
    print(f"phase 18 (a) on {card}: {time.perf_counter() - t0:.1f} s")


def phase18_rank(w: str, seed: int) -> int:
    """One rank of phase 18 (``--phase18-rank W``, under torchrun): joins
    the NCCL group, loads the kernels the parent built, runs (b) and writes
    ``W/rank{r}.json``. Rank 0 prints."""
    import datetime
    import os

    import torch

    _build, mods = import_port()
    from clip_for_dl_tpu_torch.parallel import multihost

    dev = multihost.init_process_group(device="cuda",
                                       timeout=datetime.timedelta(seconds=DP_PG_TIMEOUT))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    out = {"ok": False, "launches": {}, "results": {}}
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        _build.build()
        degrees = [s for s in PP_DEGREES if world % s == 0] or [1]
        print(f"phase 18 (b): world size {world} over NCCL; pp {degrees}")
        pp_steps18(_build, mods, dev, seed, w, degrees, out)
        if world > 1:
            pp_cli18(_build, mods, dev, w, out)
        out["ok"] = True
    finally:
        with open(f"{w}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        multihost.destroy()
    return 0


def pp_group_grads(model, label_fn, mesh) -> dict:
    """group_grads of a model whose text tower a pipeline shards: every
    other stage's layers' gradients gathered from their stage."""
    import torch

    from clip_for_dl_tpu_torch.parallel import pp

    tower, gathered = model.text_tower, {}
    if mesh.model_size > 1:
        own = pp._stage_layers(tower, mesh.model_index, mesh.model_size)
        layers = pp._layers(tower)
        for i, grads in pp._gathered(own, lambda m: [p.grad for p in m.parameters()],
                                     mesh).items():
            gathered.update({id(p): g for p, g in zip(layers[i].parameters(), grads)})
    parts: dict = {}
    for name, p in model.named_parameters():
        g = gathered.get(id(p), torch.zeros_like(p) if p.grad is None else p.grad)
        label = name if name in CALIBRATION else label_fn(tuple(name.split(".")))
        parts.setdefault(label, []).append(g.float().flatten())
    return {k: torch.cat(v) for k, v in parts.items()}


def pp_steps18(_build, mods, dev, seed: int, w: str, degrees, out: dict) -> None:
    """Phase 18 (b): the phase-A step (ResNet-50 + BERT-base, dropout 0) at
    a global batch of DP_BATCH through ``pipeline_parallel_step`` at each pp
    degree (at one card S = 1: PP_MICROBATCHES microbatches, no hop), on the
    fp32 route against the data-parallel step over every rank (at one card
    the single-card step) on the same batch at TOL dp_bn fp32: the loss and
    each group's gradient, the stage layers' gathered over the stage group;
    no kernel but B2 launches in a pipelined step (path pp_step_{S}, B2 held
    at its first inputs). With more than one card each route's bf16
    samples/s over PP_STEPS steps and its peak memory a card. At one card the
    S = 1 state is written to W/ckpt_pp/unstacked as ``pretrain --pp``
    writes it, for the parent's zeroshot."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.parallel import data_parallel_step, pp
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import CheckpointManager, TrainState, make_label_fn

    group, world = dist.group.WORLD, dist.get_world_size()
    batch = train_batch(np.random.default_rng(seed + 181), tokenizer(), dev, DP_BATCH,
                        TRAIN_LEN)

    def run(s, compute, steps=1):
        """(losses, the first step's group gradients, step seconds, config,
        groups, state, mesh): the pipelined step at ``s`` stages, or without
        it the data-parallel (one card: the single-card) step."""
        preset, cfg, model = train_model(dev, seed, "pretrain_clip", compute)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        groups = [g.name for g in preset.train.groups]
        label_fn = make_label_fn(groups)
        if s is None:
            kw = {"group": group} if world > 1 else {}
            opt, step = pretrain_step(model, preset, cfg, compute, **kw)
            state, mesh = TrainState(model, opt), None
            step = data_parallel_step(step, group) if world > 1 else step
            gen = torch.Generator(dev).manual_seed(seed + dist.get_rank())
        else:
            mesh = pp.create_dp_pp_mesh(s)
            opt, step = pretrain_step(model, preset, cfg, compute, make=lambda *a, **kw: (
                pp.make_pp_clip_pretrain_step(*a[:3], mesh, PP_MICROBATCHES, **kw)))
            state = pp.shard_state_pp(TrainState(model, opt), mesh)
            step, gen = pp.pipeline_parallel_step(step, mesh), mesh.generator(seed, dev)
        losses, times, grads = [], [], None
        for i in range(steps):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            losses.append(float(step(state, batch, base_lrs(preset), gen)[1]["loss"]))
            times.append(time.perf_counter() - t)
            if i == 0:
                grads = (group_grads(model, label_fn) if mesh is None
                         else pp_group_grads(model, label_fn, mesh))
        return losses, grads, times, cfg, groups, state, mesh

    with fp32_exact():
        ref_losses, ref_grads, _, cfg, groups, _, _ = run(None, torch.float32)
        torch.cuda.empty_cache()
        for s in degrees:
            which = {"image_prep": None}
            stack, kept = first_inputs(mods, which)
            torch.cuda.synchronize(dev)
            _build.reset_launches()
            with stack:
                losses, grads, _, _, _, state, mesh = run(s, torch.float32)
            torch.cuda.synchronize(dev)
            path = f"pp_step_{s}"
            out["launches"][path] = dict(_build.LAUNCHES)
            others = {k: v for k, v in _build.LAUNCHES.items()
                      if k != mods["image_prep"].KERNEL and v}
            rel, cos = TOL["dp_bn"]["fp32"]
            ref = "the data-parallel step" if world > 1 else "the single-card step"
            print(f"phase 18 (b) step, fp32 route, pp {s} ({world // s} x {s}), "
                  f"{PP_MICROBATCHES} microbatches, global batch {DP_BATCH}, {describe(cfg)}: "
                  f"loss {losses[0]:.6f} against {ref_losses[0]:.6f} from {ref}; launches "
                  f"{out['launches'][path]}")
            check(not others, f"pp {s}: a kernel other than B2 launched in the step: {others}")
            check(abs(losses[0] - ref_losses[0]) <= rel * abs(ref_losses[0]),
                  f"pp {s}: the fp32 step's loss differs from {ref}'s")
            compare_groups(f"phase 18 pp {s}", grads, ref_grads, groups,
                           {g: cos.get(g, TOL["fp32_grad_cos"]) for g in groups})
            hold_first_inputs(mods, kept, which, path, out["results"])
            if world == 1:
                # the canonical whole model, as pretrain --pp writes it
                with pp.whole_state(TrainState(state.model, None), mesh) as whole:
                    fm = CheckpointManager(f"{w}/ckpt_pp/unstacked", max_to_keep=1)
                    fm.save(0, whole)
                    fm.wait()
            del state, grads
            torch.cuda.empty_cache()
    if world == 1:
        return
    for s in [None] + list(degrees):
        name = "dp" if s is None else f"pp {s}"
        torch.cuda.reset_peak_memory_stats(dev)
        losses, _, times, _, _, state, _ = run(s, torch.bfloat16, PP_STEPS)
        torch.cuda.synchronize(dev)
        rate = DP_BATCH * (len(times) - 1) / sum(times[1:])
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        print(f"  bf16 {name}: {rate:.1f} samples/s over steps 1-{PP_STEPS - 1} (global batch "
              f"{DP_BATCH}); peak {_peak_mib(dev):.0f} MiB a card; losses "
              f"{[round(v, 4) for v in losses]}")
        del state
        torch.cuda.empty_cache()


def pp_cli18(_build, mods, dev, w: str, out: dict) -> None:
    """Phase 18 (b), more than one card: ``pretrain --num-devices <cards>
    --pp 2 --pp-microbatches PP_MICROBATCHES --fp32 --flash-attention
    --bert-fused-mlp`` through ``cli.main`` (path cli_pp_pretrain: B2 in each
    step, B3's fp32 instance in the eval pass on the gathered tower, each
    held at its first inputs) with every preset's dropout at 0, TF32 off:
    its first step's loss against one card's fp32 step from the weights and
    on the global batch it started from (TOL pp_command_rel), its
    ``unstacked/`` checkpoint whole (the unsharded names and shapes), and
    no file written by a rank other than 0."""
    import dataclasses
    import importlib
    import io
    import os
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.core import config
    from clip_for_dl_tpu_torch.models import CXRClip
    from clip_for_dl_tpu_torch.parallel import pp
    from clip_for_dl_tpu_torch.parallel.collectives import all_gather_rows
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact, recorded_writes
    from clip_for_dl_tpu_torch.tools.main_paths import pretrain_step
    from clip_for_dl_tpu_torch.train import TrainState, loop

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    world, rank = dist.get_world_size(), dist.get_rank()
    workdir = os.path.dirname(w)
    argv = ["pretrain", "--vocab", f"{workdir}/cli/vocab.txt", "--fp32", "--flash-attention",
            "--bert-fused-mlp", "--synthetic", "--synthetic-samples", str(2 * PP_CLI_BATCH),
            "--batch-size", str(PP_CLI_BATCH), "--epochs", "1", "--num-devices", str(world),
            "--pp", "2", "--pp-microbatches", str(PP_MICROBATCHES), "--checkpoint-dir",
            f"{w}/ckpt_pp", "--log-dir", f"{w}/logs_pp"]
    real_preset = config.get_preset

    def no_dropout(name):
        cfg = real_preset(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0))

    first, run_epoch = {}, loop.run_epoch

    def kept_epoch(step_fn, state, loader, *a, **kw):
        def kept_step(st, batch, *rest):
            if first:
                return step_fn(st, batch, *rest)
            mesh = pp.create_dp_pp_mesh(2)
            with pp.whole_state(TrainState(st.model, None), mesh):
                weights = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
            rows = {k: all_gather_rows(v, mesh.data_group) for k, v in batch.items()
                    if torch.is_tensor(v)}
            st, metrics = step_fn(st, batch, *rest)
            first.update(config=st.model.config, weights=weights, batch=rows,
                         loss=float(metrics["loss"]))
            return st, metrics

        return run_epoch(kept_step, state, loader, *a, **kw)

    path, which = "cli_pp_pretrain", dict.fromkeys(("image_prep", "flash_attention"))
    stack, kept = first_inputs(mods, which)
    text = io.StringIO()
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with stack, fp32_exact(), mock.patch.object(config, "get_preset", no_dropout), \
            mock.patch.object(loop, "run_epoch", kept_epoch), redirect_stdout(text), \
            recorded_writes() as written:
        rc = cli.main(argv)
    torch.cuda.synchronize(dev)
    check(rc == 0, f"phase 18 (b): pretrain --pp 2 exited with {rc}: {text.getvalue()[-2000:]}")
    out["launches"][path] = dict(_build.LAUNCHES)
    print(f"phase 18 (b): pretrain --num-devices {world} --pp 2 --pp-microbatches "
          f"{PP_MICROBATCHES} --fp32, dropout 0: exit 0 in {time.perf_counter() - t0:.1f} s; "
          f"launches {out['launches'][path]}")
    hold_first_inputs(mods, kept, which, path, out["results"])
    mine = [p for p in written if p.startswith(w)]
    check(rank == 0 or not mine, f"rank {rank} wrote {mine[:5]}")
    model = CXRClip(first["config"]).to(dev)
    model.load_state_dict(first["weights"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    preset = cli._preset(argparse.Namespace(preset="pretrain_clip"))
    with fp32_exact():
        opt, step = pretrain_step(model, preset, first["config"], torch.float32)
        _, metrics = step(TrainState(model, opt), first["batch"],
                          {**{g.name: g.lr for g in preset.train.groups},
                           "default": preset.train.lr})
    loss, rel = float(metrics["loss"]), TOL["pp_command_rel"]
    print(f"  first step's loss {first['loss']:.6f} against {loss:.6f} from one card's fp32 "
          f"step on the global batch of {PP_CLI_BATCH} (tol {rel} relative)")
    check(abs(first["loss"] - loss) <= rel * abs(loss), "--pp 2: the command's first step "
                                                        "differs from one card's")
    saved = torch.load(f"{w}/ckpt_pp/unstacked/0.pt", map_location="cpu", mmap=True,
                       weights_only=False)["model"]
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    check({k: tuple(v.shape) for k, v in saved.items()} == shapes,
          "the unstacked checkpoint is not the whole model")
    print(f"  unstacked/: {len(saved)} tensors, the whole model's names and shapes; rank "
          f"{rank} wrote {len(mine)} files under the phase's directory")
    del saved, model, first
    torch.cuda.empty_cache()


# -- phase 19: remat, bf16 probabilities, every command over a group -----------------------


REMAT_FORMS = ("none", "full", "dots", "dots_no_batch")  # phase 19 (a)'s forms, "none" first
REMAT_STEPS = 4  # phase 19 (a) and (b)'s timed steps of each form (the first not counted)
GROUP_CACHE_ROWS = 32  # phase 19 (c): the projections rows cache-images caches over the group
GROUP_TIMEOUT = 360  # seconds phase 19's torchrun may take, the build's load included


def set_remat(model, policy: str) -> None:
    """The towers' layers (the ResNet's blocks) under ``policy``, which
    ``--remat --remat-policy`` builds them with (models/remat.py)."""
    model.text_tower.remat_policy = policy
    model.image_tower.remat_policy = policy


def set_switch(model, name: str, value: bool) -> None:
    """``name`` (``flash``, ``bf16_probs``) on every module that has it."""
    for m in model.modules():
        if isinstance(getattr(m, name, None), bool):
            setattr(m, name, value)


def timed_steps(_build, dev, step, state, batch, lrs, seed: int, n: int):
    """``n`` synced steps from a fresh count and peak: (samples/s over
    steps 1…n−1, the peak of device memory in GiB, the launches, the
    losses)."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    times, losses = [], []
    for _ in range(n):
        t = time.perf_counter()
        losses.append(float(step(state, batch, lrs, gen)[1]["loss"]))  # syncs the step
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize(dev)
    rate = TRAIN_BATCH * (n - 1) / sum(times[1:])
    return rate, torch.cuda.max_memory_allocated(dev) / 2 ** 30, dict(_build.LAUNCHES), losses


def remat_phase19(_build, mods, dev, seed: int, card: str, workdir: str, results: dict) -> dict:
    """Phase 19: (a) the phase-A step under ``--remat`` in each policy, (b)
    the plain attention route with ``--bf16-attention-probs``, (c) every
    command over a group (group_cli19). Returns the launches by path."""
    import numpy as np
    import torch

    from clip_for_dl_tpu_torch.tools.main_paths import (
        base_lrs, pretrain_step, tokenizer, train_batch, train_model,
    )
    from clip_for_dl_tpu_torch.train import TrainState, make_label_fn

    t_phase = time.perf_counter()
    # built as --remat builds it (remat, remat_conv, the policy on both towers)
    preset, cfg, model = train_model(dev, seed, "pretrain_clip", remat=True, remat_conv=True)
    check(model.text_tower.remat_policy == model.image_tower.remat_policy == "full",
          "the --remat model's towers are not under the full policy")
    groups = [g.name for g in preset.train.groups]
    lrs, label_fn = base_lrs(preset), make_label_fn(groups)
    batch = train_batch(np.random.default_rng(seed + 2), tokenizer(), dev, TRAIN_BATCH,
                        TRAIN_LEN)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def fresh(dropout: float):
        model.load_state_dict(init)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = dropout
        opt, step = pretrain_step(model, preset, cfg)
        return TrainState(model, opt), step

    def one_step():
        state, step = fresh(0.0)
        loss = float(step(state, batch, lrs)[1]["loss"])
        return loss, group_grads(model, label_fn)

    def against(what, got, want):
        loss_err = abs(got[0] - want[0]) / abs(want[0])
        print(f"  {what}: first step, dropout 0: loss {got[0]:.6f} against {want[0]:.6f} "
              f"(rel {loss_err:.2e}, tol {TOL['train_loss_rel']:.0e})")
        check(loss_err <= TOL["train_loss_rel"], f"{what}: the loss differs")
        compare_groups(what, got[1], want[1], groups, TOL["grad_cos"])

    by_path, rows = {}, []
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    # -- (a) --remat: each policy's first step against the step without ------------
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        set_remat(model, "none")
        plain = one_step()
        for policy in REMAT_FORMS[1:]:
            set_remat(model, policy)
            against(f"--remat --remat-policy {policy}", one_step(), plain)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    del plain
    keys = {k: KERNELS[k][0] for k in ("flash_attention", "mlp", "flash_attention_bwd",
                                       "mlp_bwd")}
    for policy in REMAT_FORMS:
        set_remat(model, policy)
        state, step = fresh(cfg.dropout)
        rate, peak, launches, losses = timed_steps(_build, dev, step, state, batch, lrs, seed,
                                                   REMAT_STEPS)
        per_step = {k: launches.get(v, 0) / REMAT_STEPS for k, v in keys.items()}
        rows.append((policy, rate, peak))
        print(f"  --remat-policy {policy}: {rate:.1f} samples/s, peak {peak:.2f} GiB, "
              f"launches a step {per_step} on {card}; losses {[round(x, 4) for x in losses]}")
        check(all(np.isfinite(losses)), f"--remat {policy}: non-finite losses {losses}")
        if policy == "none":
            continue
        by_path[f"remat_train_{policy}"] = launches
        check_launched(mods, launches, f"remat_train_{policy}")
        if policy == "full":
            # the recompute runs B3 and B4 again in every layer's backward
            want = {"flash_attention": 24, "mlp": 24, "flash_attention_bwd": 12, "mlp_bwd": 12}
            check(per_step == want, f"--remat full launches {per_step} a step, not {want}")
    full_peak, none_peak = rows[1][2], rows[0][2]
    print(f"phase 19 (a) on {card}: samples/s and peak GiB by form "
          f"{[(p, round(r, 1), round(m, 2)) for p, r, m in rows]}")
    check(full_peak < none_peak, f"--remat full peaks at {full_peak:.2f} GiB, not below the "
                                 f"step without remat's {none_peak:.2f} GiB")

    # -- (b) --bf16-attention-probs on the plain attention route -------------------
    set_remat(model, "none")
    set_switch(model, "flash", False)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        set_switch(model, "bf16_probs", False)
        plain = one_step()
        set_switch(model, "bf16_probs", True)
        against("--bf16-attention-probs, plain route", one_step(), plain)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    del plain
    peaks = {}
    for on in (False, True):
        set_switch(model, "bf16_probs", on)
        state, step = fresh(cfg.dropout)
        rate, peaks[on], launches, losses = timed_steps(_build, dev, step, state, batch, lrs,
                                                        seed, REMAT_STEPS)
        name = "--bf16-attention-probs" if on else "fp32 probabilities"
        print(f"  plain route, {name}: {rate:.1f} samples/s, peak {peaks[on]:.2f} GiB on "
              f"{card}; launches {launches}")
        check(all(np.isfinite(losses)), f"plain route {name}: non-finite losses {losses}")
        check(launches.get(KERNELS["flash_attention"][0], 0) == 0,
              "the plain attention route launched B3")
        if on:
            by_path["bf16_probs_train"] = launches
            check_launched(mods, launches, "bf16_probs_train")
    check(peaks[True] < peaks[False], f"--bf16-attention-probs peaks at {peaks[True]:.2f} GiB, "
                                      f"not below the plain route's {peaks[False]:.2f} GiB")
    del model, state, step, init
    torch.cuda.empty_cache()
    print(f"phase 19 (a), (b): {time.perf_counter() - t_phase:.1f} s")
    by_path.update(group_cli19(_build, mods, dev, card, workdir, results))
    print(f"phase 19 on {card}: {time.perf_counter() - t_phase:.1f} s")
    return by_path


def group_argvs(workdir: str, out: str) -> dict:
    """Phase 19 (c)'s commands on phase 9's files, their outputs under
    ``out``: name -> (argv, the kernels held at their first inputs)."""
    work, kaggle = f"{workdir}/cli", f"{workdir}/kaggle"
    data = ["--reports-csv", f"{work}/labeled.csv", "--projections-csv",
            f"{kaggle}/indiana_projections.csv", "--image-dir",
            f"{kaggle}/images/images_normalized", "--image-cache", f"{work}/cache", "--vocab",
            f"{work}/vocab.txt", "--flash-attention", "--bert-fused-mlp"]
    bank = ("image_prep", "flash_attention", "mlp")
    return {
        "eval": (["eval", *data, "--checkpoint", f"{work}/adapter", "--log-dir",
                  f"{out}/eval"], ("similarity",) + bank),
        "gradcam": (["gradcam", *data, "--checkpoint", f"{work}/adapter", "--sample_index", "3",
                     "--log-dir", f"{out}/gradcam"], bank),
        "prep": (["prep", "--reports", f"{kaggle}/indiana_reports.csv", "--out",
                  f"{out}/labeled.csv", "--unlabeled-out", f"{out}/unlabeled.csv"], ()),
        "cache-images": (["cache-images", "--image-dir", f"{kaggle}/images/images_normalized",
                          "--out", f"{out}/cache", "--projections-csv",
                          f"{os.path.dirname(out)}/projections.csv", "--image-size", "224"], ()),
        "convert": (["convert", "--vocab", f"{work}/vocab.txt", "--checkpoint",
                     f"{work}/adapter", "--out", f"{out}/model.safetensors"], ()),
    }


@contextmanager
def drawn_overlays(out: str):
    """gradcam's overlays saved as .npy arrays under ``out`` where the
    command would draw its PNGs (the card's machine has no matplotlib)."""
    import importlib

    import numpy as np

    viz = importlib.import_module("clip_for_dl_tpu_torch.utils.visualization")
    os.makedirs(out, exist_ok=True)

    def record(image, path=None, title=""):
        np.save(f"{out}/{os.path.basename(path)}.npy", np.asarray(image))
        return path

    with mock.patch.object(viz, "save_or_show_image", record):
        yield


def run_group_commands(_build, mods, dev, w: str, out: str, results: dict, where: str):
    """group_argvs' commands through ``cli.main`` in this process (over the
    group it has joined, or alone): (path -> launches, the paths opened for
    writing); each command's kernels held at their first inputs where it
    ran."""
    import importlib
    import io
    from contextlib import redirect_stdout

    import torch

    from clip_for_dl_tpu_torch.testing.ranks import recorded_writes

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    launches, written = {}, []
    for name, (argv, hold) in group_argvs(os.path.dirname(w), out).items():
        which = dict.fromkeys(hold)
        stack, kept = first_inputs(mods, which)
        text = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        with stack, drawn_overlays(f"{out}/overlays"), redirect_stdout(text), \
                recorded_writes() as paths:
            rc = cli.main(argv)
        written += paths
        torch.cuda.synchronize(dev)
        check(rc == 0, f"phase 19 (c), {where}: {name} exited with {rc}: "
                       f"{text.getvalue()[-2000:]}")
        print(f"phase 19 (c), {where}: {name}: exit 0 in {time.perf_counter() - t0:.1f} s; "
              f"launches {dict(_build.LAUNCHES)}")
        if hold:
            path = f"cli_group_{name}"
            launches[path] = dict(_build.LAUNCHES)
            if kept:  # the command ran here (gradcam runs on the primary alone)
                check_launched(mods, launches[path], path)
                hold_first_inputs(mods, kept, which, f"{where} {name}", results)
        torch.cuda.empty_cache()
    return launches, written


def phase19_rank(w: str, seed: int) -> int:
    """One rank of phase 19 (``--phase19-rank W``, under torchrun): joins the
    NCCL group, loads the kernels the parent built, runs group_argvs'
    commands over the group into ``W/group`` and, with four cards or more,
    ``pretrain --ep 2`` over the processes against ``--num-devices``
    (ep_processes19); writes ``W/rank{r}.json``. Rank 0 prints."""
    import datetime

    import torch

    _build, mods = import_port()
    from clip_for_dl_tpu_torch.parallel import multihost

    dev = multihost.init_process_group(device="cuda",
                                       timeout=datetime.timedelta(seconds=DP_PG_TIMEOUT))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    out = {"ok": False, "launches": {}, "results": {}, "written": []}
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        _build.build()
        print(f"phase 19 (c): world size {world} over NCCL")
        out["launches"], out["written"] = run_group_commands(
            _build, mods, dev, w, f"{w}/group", out["results"], f"rank {rank} of {world}")
        if world >= 4 and world % 2 == 0:
            ep_processes19(_build, mods, dev, w, out)
        out["ok"] = True
    finally:
        with open(f"{w}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        multihost.destroy()
    return 0


def ep_processes19(_build, mods, dev, w: str, out: dict) -> None:
    """Phase 19 (c), four cards or more: ``pretrain --moe-experts 8 --ep 2
    --fp32`` over the processes (``--num-processes``: each loads the strided
    shard of its data index) against the same command over the group as
    ``--num-devices`` (every rank loading the global batch, its slice fed),
    dropout 0, TF32 off, a capacity that keeps every token (the processes'
    shards hold the global batch's rows in another order): the first
    step's loss at TOL moe_ep_command_rel (path cli_ep_processes)."""
    import dataclasses
    import importlib
    import io
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    from clip_for_dl_tpu_torch.core import config
    from clip_for_dl_tpu_torch.testing.ranks import fp32_exact
    from clip_for_dl_tpu_torch.train import loop

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    world = dist.get_world_size()
    workdir = os.path.dirname(w)
    real_preset = config.get_preset

    def wide(name):
        cfg = real_preset(name)
        return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0,
                                                     moe_capacity_factor=float(MOE_EXPERTS)))

    losses = {}
    for how, flags in (("devices", ["--num-devices", str(world)]),
                       ("processes", ["--num-processes", str(world)])):
        argv = ["pretrain", "--vocab", f"{workdir}/cli/vocab.txt", "--fp32",
                "--flash-attention", "--synthetic", "--synthetic-samples",
                str(2 * MOE_CLI_BATCH), "--batch-size", str(MOE_CLI_BATCH), "--epochs", "1",
                "--moe-experts", str(MOE_EXPERTS), "--ep", "2", *flags, "--checkpoint-dir",
                f"{w}/ckpt_{how}", "--log-dir", f"{w}/logs_{how}"]
        first, run_epoch = [], loop.run_epoch

        def kept_epoch(step_fn, state, loader, *a, **kw):
            def kept_step(st, batch, *rest):
                st, metrics = step_fn(st, batch, *rest)
                first.append(float(metrics["loss"]))
                return st, metrics

            return run_epoch(kept_step, state, loader, *a, **kw)

        text = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        with fp32_exact(), mock.patch.object(config, "get_preset", wide), \
                mock.patch.object(loop, "run_epoch", kept_epoch), redirect_stdout(text):
            rc = cli.main(argv)
        check(rc == 0, f"phase 19 (c): pretrain --ep 2 over the {how} exited with {rc}: "
                       f"{text.getvalue()[-2000:]}")
        losses[how] = first[0]
        if how == "processes":
            out["launches"]["cli_ep_processes"] = dict(_build.LAUNCHES)
    rel = abs(losses["processes"] - losses["devices"]) / abs(losses["devices"])
    print(f"phase 19 (c): pretrain --ep 2 --moe-experts {MOE_EXPERTS} --fp32 over {world} "
          f"processes: first step's loss {losses['processes']:.6f} against "
          f"{losses['devices']:.6f} over --num-devices {world} (rel {rel:.2e}, tol "
          f"{TOL['moe_ep_command_rel']})")
    check(rel <= TOL["moe_ep_command_rel"], "pretrain --ep 2 over the processes differs")


def labeled_rows(data: bytes) -> list:
    """prep's labeled CSV with each row's ``extracted_labels`` as a set: the
    reference joins a set there, in the order of the process's string hashes
    (PYTHONHASHSEED), so two processes write it in other orders."""
    rows = list(csv.reader(data.decode().splitlines()))
    i = rows[0].index("extracted_labels")
    return [r[:i] + [frozenset(r[i].split(", "))] + r[i + 1:] for r in rows]


def group_cli19(_build, mods, dev, card: str, workdir: str, results: dict) -> dict:
    """Phase 19 (c): ``torchrun --nproc-per-node <cards> chip_smoke.py
    --phase19-rank DIR`` (phase19_rank) runs ``eval``,
    ``gradcam``, ``prep``, ``cache-images`` (GROUP_CACHE_ROWS rows of phase
    9's projections) and ``convert`` on phase 9's files over the group
    (paths cli_group_*@rank{r}, the kernels held at their first inputs where
    the command ran); the same commands then run here alone (cli_group_*_alone).
    prep's labeled CSV is compared with each row's ``extracted_labels`` as a
    set (labeled_rows). The files equal the group's: byte for
    byte at one card (eval_predictions.csv at more: probabilities within 5e-3
    and the decided predictions equal), gradcam's overlays equal, nothing
    written by a rank other than 0."""
    import numpy as np
    import torch

    w = f"{workdir}/phase19"
    os.makedirs(w, exist_ok=True)
    with open(f"{workdir}/kaggle/indiana_projections.csv", newline="") as f:
        rows = list(csv.reader(f))
    with open(f"{w}/projections.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows[:GROUP_CACHE_ROWS + 1])
    world = torch.cuda.device_count()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", str(ROOT / "chip_smoke.py"), "--phase19-rank", w]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=GROUP_TIMEOUT)
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"phase 19's ranks ran past {GROUP_TIMEOUT} s: "
                           f"{(exc.stdout or '')[-3000:]}")
    print(proc.stdout.rstrip())
    if proc.returncode:
        print(proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"phase 19's torchrun exited with {proc.returncode}")
    by_path = {}
    for r in range(world):
        with open(f"{w}/rank{r}.json") as f:
            out = json.load(f)
        check(out["ok"], f"phase 19, rank {r} did not finish")
        check(r == 0 or not out["written"], f"phase 19: rank {r} wrote {out['written']}")
        for path, launches in out["launches"].items():
            if path == "cli_ep_processes":
                check_launched(mods, launches, path)
            by_path[f"{path}@rank{r}"] = launches
        for name, v in out["results"].items():
            results.setdefault(name, {})["max_abs_err"] = max(
                v["max_abs_err"], results.get(name, {}).get("max_abs_err", 0.0))
    print(f"phase 19 (c): torchrun {time.perf_counter() - t0:.1f} s")
    alone, _ = run_group_commands(_build, mods, dev, w, f"{w}/single", results, "alone")
    by_path.update({f"{p}_alone": v for p, v in alone.items()})

    def files(root):
        out = {}
        for d, _, names in os.walk(root):
            for name in names:
                if not name.endswith(".log"):
                    with open(os.path.join(d, name), "rb") as f:
                        out[os.path.relpath(os.path.join(d, name), root)] = f.read()
        return out

    got, want = files(f"{w}/group"), files(f"{w}/single")
    check(got.keys() == want.keys(), f"the group wrote {sorted(got)}, one process "
                                     f"{sorted(want)}")
    csvs = [k for k in want if k.endswith("eval_predictions.csv")]
    same = [k for k in want if got[k] == want[k]
            or k == "labeled.csv" and labeled_rows(got[k]) == labeled_rows(want[k])]
    print(f"phase 19 (c): {len(same)} of {len(want)} files equal to one process's, byte for "
          f"byte (labeled.csv's extracted_labels as sets) ({', '.join(sorted(want))})")
    if world == 1:
        check(len(same) == len(want), f"files differ: {sorted(set(want) - set(same))}")
    else:
        check(set(want) - set(same) <= set(csvs),
              f"files other than eval's differ: {sorted(set(want) - set(same) - set(csvs))}")
        for k in csvs:
            a, b = (np.array(list(csv.reader(d[k].decode().splitlines()))[1:], np.float64)
                    for d in (got, want))
            err = float(np.abs(a[:, 0::2] - b[:, 0::2]).max())
            decided = np.abs(b[:, 0::2] - 0.5) > 5e-3
            print(f"  {k}: probabilities within {err:.2e} of one card's (tol 5e-3); the "
                  f"decided predictions ({int(decided.sum())} of {decided.size}) equal")
            check(err <= 5e-3 and np.array_equal((a[:, 0::2] > 0.5)[decided],
                                                 (b[:, 0::2] > 0.5)[decided]),
                  f"{k} over {world} processes differs from one card's")
    check(any(k.startswith("overlays") for k in want), "gradcam drew no overlay")
    return by_path



# -- phase 20: image decoding beyond PNG (ROADMAP A2c) -------------------------------------

JPEG_BIG = 4  # phase 20 (b): frontal views of the layout written at JPEG_BIG_SHAPE
JPEG_BIG_SHAPE = (2828, 2320)  # rows, columns: a large digital radiograph
JPEG_TIMED = 9  # decodes each phase-20 time is the median of
JPEG_SERVE_CLIENTS, JPEG_SERVE_PER_CLIENT = 8, 32  # phase 20 (c)'s concurrent passes
JPEG_SERVE_ROUNDS = 2  # passes over the bodies one by one
JPEG_BODY_SIDE = 2048  # the side of phase 20 (c)'s grey bodies

# the yardstick of phases 20 and 21: cv2 in a child process, so that the
# smoke's own process never imports it. ``python -c CV2_CHILD TASK OUT``:
# TASK (JSON) has "cases", the images to write ("fmt": the encoder, cv2's
# extension or "pil-jpeg-tiff"; the picture's size, channels and bits;
# "params", pairs of cv2 names and values; an EXIF "orientation" spliced
# into a JPEG) or the files already written (no "fmt"), each decoded by
# cv2.imdecode into "decoded" and, where the case names it, by cv2.imread
# into "read" (RGB .npy, or no file where cv2 gives no image); and
# "layout", the layout's PNGs to write again, each as its grey (resized to
# "big"; at 16 bits in the samples' high bytes, their low bytes noise) in
# every format of its "outputs". OUT (JSON) gets cv2's version, its JPEG and
# TIFF libraries, its decode times and the cases it could not write.
CV2_CHILD = r'''
import json, shutil, sys, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
try:
    import cv2
except ImportError as exc:
    sys.exit(f"the phase needs cv2 installed, its yardstick: {exc}")

task = json.load(open(sys.argv[1]))
out = {"cv2": cv2.__version__, "ms": {}, "skipped": [], "libs": {
    key: next((line.split(":", 1)[1].strip() for line in cv2.getBuildInformation().splitlines()
               if line.strip().startswith(key + ":")), "none") for key in ("JPEG", "TIFF")}}


def image(h, w, c, seed, bits=8):
    """A smooth picture with noise, as radiographs are."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    wave = np.outer(np.cos(np.arange(h) / 13), np.sin(np.arange(w) / (9 + seed % 5)))
    base = top / 255 * (128 + 60 * wave + rng.normal(0, 4, (h, w)))
    grey = np.clip(base, 0, top).astype(np.uint16 if bits == 16 else np.uint8)
    channels = [grey, np.roll(grey, 7, 0), np.roll(grey, 11, 1), np.roll(grey, 5, 0)]
    return grey if c == 1 else np.stack(channels[:c], -1)


def exif(orientation):
    """An APP1 segment: Exif, a little-endian TIFF header, IFD0 with the
    orientation alone."""
    tiff = (b"II*\0" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + orientation.to_bytes(2, "little") + b"\0\0"
            + (0).to_bytes(4, "little"))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body


def encode(img, fmt, params, orientation=0):
    flat = []
    for key, value in params:
        flat += [getattr(cv2, key), getattr(cv2, value) if isinstance(value, str) else value]
    ok, buf = cv2.imencode(fmt, img, flat)
    assert ok, fmt
    data = buf.tobytes()
    if orientation:  # after SOI and the JFIF segment
        at = 4 + int.from_bytes(data[4:6], "big") if data[2:4] == b"\xff\xe0" else 2
        data = data[:at] + exif(orientation) + data[at:]
    return data


def write(case):
    img = image(case["h"], case["w"], case["c"], case["seed"], case.get("bits", 8))
    if case["fmt"] == "pil-jpeg-tiff":  # cv2 writes no JPEG-compressed TIFF
        try:
            from PIL import Image
        except ImportError:
            out["skipped"].append(case["name"])
            return False
        Image.fromarray(img).save(case["path"], "TIFF", compression="jpeg", quality=90)
        return True
    with open(case["path"], "wb") as f:
        f.write(encode(img, case["fmt"], case["params"], case.get("orientation", 0)))
    return True


def decode(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def read(path):
    try:
        img = cv2.imread(path)
    except cv2.error:
        img = None
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


for case in task["cases"]:
    if "fmt" in case and not write(case):
        continue
    with open(case["path"], "rb") as f:
        data = f.read()
    for key, got in (("decoded", decode(data)),
                     ("read", read(case["path"]) if "read" in case else None)):
        if got is not None:
            np.save(case[key], got)
    if case["timed"]:
        times = []
        for _ in range(task["timed"]):
            t0 = time.perf_counter()
            decode(data)
            times.append((time.perf_counter() - t0) * 1e3)
        out["ms"][case["name"]] = float(np.median(times))


def layout_file(job):
    grey = cv2.imread(job["src"], cv2.IMREAD_GRAYSCALE)
    if grey is None:  # the layout's file that is no image, copied as it is
        for dst, *_ in job["outputs"]:
            shutil.copyfile(job["src"], dst)
        return
    if job["big"]:
        grey = cv2.resize(grey, (job["big"][1], job["big"][0]), interpolation=cv2.INTER_LINEAR)
    img = grey
    if job["bits"] == 16:
        low = np.random.default_rng(job["seed"]).integers(0, 256, grey.shape, dtype=np.uint16)
        img = (grey.astype(np.uint16) << 8) | low
    for dst, fmt, params, decoded in job["outputs"]:
        data = encode(img, fmt, params)
        with open(dst, "wb") as f:
            f.write(data)
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        back = np.ascontiguousarray(bgr[..., 0])
        assert (bgr == back[..., None]).all(), dst
        if decoded:
            np.save(decoded, back)
        else:  # an output of a lossless format gives back the PNG's grey
            assert (back == grey).all(), dst


with ThreadPoolExecutor(8) as pool:  # cv2 drops the interpreter lock
    list(pool.map(layout_file, task["layout"]))
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
'''


def jpeg_params(quality=90, progressive=0, sampling=None, restart=0) -> list:
    """CV2_CHILD's "params" for cv2's JPEG encoder."""
    params = [["IMWRITE_JPEG_QUALITY", quality], ["IMWRITE_JPEG_PROGRESSIVE", progressive],
              ["IMWRITE_JPEG_RST_INTERVAL", restart]]
    if sampling:
        params.append(["IMWRITE_JPEG_SAMPLING_FACTOR", "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling])
    return params


def jpeg_phase20(_build, mods, dev, seed: int, card: str, workdir: str, results: dict) -> dict:
    """Phase 20: JPEG and BMP decoding (ROADMAP A2c, C11), on phase 8's
    layout and phase 9's files in ``workdir``; returns the launches of its
    paths. cv2 runs in a child process (CV2_CHILD) as the yardstick the
    port never calls; the phase fails if it is missing or if its JPEG
    backend is not libjpeg-turbo."""
    import argparse
    import importlib
    import io
    import os
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.data.frame import read_csv
    from clip_for_dl_tpu_torch.inference import load_trained_model
    from clip_for_dl_tpu_torch.native import decode_image, decoder
    from clip_for_dl_tpu_torch.serving import decode_request_image
    from clip_for_dl_tpu_torch.testing.png import encode_png, write_png
    from clip_for_dl_tpu_torch.testing.tiff import encode_tiff
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t_phase = time.perf_counter()
    kaggle, work9, w = f"{workdir}/kaggle", f"{workdir}/cli", f"{workdir}/phase20"
    for d in ("cases", "jpeg", "twin"):
        os.makedirs(f"{w}/{d}")
    by_path, failures, walls = {}, [], {}

    # -- the yardstick's files: (a)'s cases, (c)'s bodies, (b)'s layout -----------------------
    cases = []

    def case(name, h, w_, c, timed=False, fmt=".jpg", orientation=0, **jpeg):
        cases.append({"name": name, "fmt": fmt, "h": h, "w": w_, "c": c,
                      "seed": len(cases) + seed, "orientation": orientation, "timed": timed,
                      "params": jpeg_params(**jpeg) if fmt == ".jpg" else [],
                      "path": f"{w}/cases/{name}{fmt}", "decoded": f"{w}/cases/{name}.npy"})

    big_h, big_w = JPEG_BIG_SHAPE
    for prog in (0, 1):
        case(f"grey224-{'progressive' if prog else 'baseline'}", 224, 224, 1, True,
             progressive=prog)
        case(f"grey{big_w}x{big_h}-{'progressive' if prog else 'baseline'}", big_h, big_w, 1,
             True, progressive=prog, quality=95)
    for s in ("444", "422", "420", "411"):
        case(f"colour224-{s}", 224, 224, 3, sampling=s)
    case("colour224-420-progressive", 224, 224, 3, sampling="420", progressive=1)
    case("colour224-420-restart", 224, 224, 3, sampling="420", restart=5)
    case("colour160x224-exif6", 160, 224, 3, orientation=6)
    case(f"colour{big_w}x{big_h}-420", big_h, big_w, 3, sampling="420")
    n_decode = len(cases)
    bodies = []  # (c): (kind, case index)
    for i in range(4):
        for fmt in (".jpg", ".bmp"):
            case(f"body{i}-224{fmt[1:]}", 224, 224, 3, fmt=fmt)
            bodies.append((fmt, len(cases) - 1))
            case(f"body{i}-{JPEG_BODY_SIDE}{fmt[1:]}", JPEG_BODY_SIDE, JPEG_BODY_SIDE, 1, fmt=fmt)
            bodies.append((fmt, len(cases) - 1))
    case("refusedwebp", 64, 64, 3, fmt=".webp")
    projections = read_csv(f"{kaggle}/indiana_projections.csv")
    names = [str(n) for n in projections.column("filename")]
    frontal = [str(n) for n, v in zip(names, projections.column("projection")) if v == "Frontal"]
    big_names = set(frontal[:JPEG_BIG])
    image_dir = f"{kaggle}/images/images_normalized"
    jpeg_name = {n: n[:-4] + ".jpg" for n in names}  # *.dcm.png -> *.dcm.jpg
    layout = [{"src": f"{image_dir}/{n}", "big": list(JPEG_BIG_SHAPE) if n in big_names else None,
               "bits": 8, "seed": i, "outputs": [[f"{w}/jpeg/{jpeg_name[n]}", ".jpg",
                                                  jpeg_params(95), f"{w}/jpeg/{n}.npy"]]}
              for i, n in enumerate(names)]
    with open(f"{w}/task.json", "w") as f:
        json.dump({"cases": cases, "layout": layout, "timed": JPEG_TIMED}, f)
    t = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", CV2_CHILD, f"{w}/task.json", f"{w}/cv2.json"],
                           capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"phase 20's cv2 child failed ({child.returncode}): "
          f"{child.stderr[-3000:]}")
    with open(f"{w}/cv2.json") as f:
        yard = json.load(f)
    print(f"cv2 {yard['cv2']} (a child process, the yardstick): JPEG backend "
          f"{yard['libs']['JPEG']!r}; wrote {len(cases)} images and {len(layout)} layout JPEGs in "
          f"{time.perf_counter() - t:.1f} s")
    check("libjpeg-turbo" in yard["libs"]["JPEG"],
          f"cv2's JPEG backend is {yard['libs']['JPEG']!r}, not libjpeg-turbo: the decoder is "
          "byte-equal to libjpeg-turbo's decode only")

    # -- (a) the decoder on this machine ----------------------------------------------------
    t = time.perf_counter()
    log = decoder.compile_library(Path(f"{w}/libcxr_decode-fresh.so"))
    build_s = time.perf_counter() - t
    decoder.library()
    print(f"phase 20 (a): the decoder built with g++ {' '.join(decoder.CXX_FLAGS)} in "
          f"{build_s:.1f} s from {', '.join(str(s.relative_to(ROOT)) for s in decoder.SOURCES)}"
          + (f" ({log.strip()[:200]})" if log.strip() else "") + f"; loaded "
          f"{Path(decoder.build_info['path']).name}")
    timed = {}
    for c in cases[:n_decode]:
        with open(c["path"], "rb") as f:
            data = f.read()
        got = decode_image(data)
        want = np.load(c["decoded"])
        same = got is not None and got.shape == want.shape and np.array_equal(got, want)
        print(f"  {c['name']}: {len(data)} bytes -> {None if got is None else got.shape}, "
              f"byte-equal to cv2.imdecode: {same}")
        if not same:
            failures.append(f"(a) {c['name']}: the port's decode differs from cv2's")
        if c["timed"]:
            times = []
            for _ in range(JPEG_TIMED):
                t0 = time.perf_counter()
                decoder.decode(data)
                times.append((time.perf_counter() - t0) * 1e3)
            timed[c["name"]] = float(np.median(times))
    check(cases[n_decode - 2]["name"].endswith("exif6")
          and np.load(cases[n_decode - 2]["decoded"]).shape == (224, 160, 3),
          "EXIF orientation 6 did not turn the image")
    print("  decode ms (median of %d, one thread) on this host, the port's C++ beside "
          "cv2.imdecode: " % JPEG_TIMED + "; ".join(
              f"{k} {v:.2f} vs {yard['ms'][k]:.2f}" for k, v in timed.items()))

    # -- (b) files: the layout as JPEGs and its PNG twin -----------------------------------
    t = time.perf_counter()

    def twin(n):
        src = f"{w}/jpeg/{n}.npy"
        if os.path.exists(src):
            write_png(f"{w}/twin/{n}", np.load(src), level=1)
            os.remove(src)
        else:
            shutil.copyfile(f"{image_dir}/{n}", f"{w}/twin/{n}")

    with ThreadPoolExecutor(8) as pool:  # zlib drops the interpreter lock
        list(pool.map(twin, names))
    jpeg_csv = f"{w}/jpeg_projections.csv"
    with open(f"{kaggle}/indiana_projections.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    with open(jpeg_csv, "w", newline="") as f:
        out = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        out.writeheader()
        out.writerows({**r, "filename": jpeg_name[r["filename"]]} for r in rows)
    print(f"phase 20 (b): {len(names)} layout files as JPEG q95 (the frontal views of "
          f"{sorted(big_names)} at {big_w}x{big_h}), their PNG twin of cv2's decodes written by "
          f"testing/png.py in {time.perf_counter() - t:.1f} s")
    layouts = {"jpeg": (jpeg_csv, f"{w}/jpeg"),
               "twin": (f"{kaggle}/indiana_projections.csv", f"{w}/twin")}

    def run(name, argv, path=None):
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        with redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}: {out.getvalue()[-2000:]}")
        if path:
            by_path[path] = dict(_build.LAUNCHES)
            check_launched(mods, by_path[path], path)
        torch.cuda.empty_cache()
        return out.getvalue()

    rates, caches = {}, {}
    for tag, (csv_path, directory) in layouts.items():
        for workers in (1, 8):
            cache = f"{w}/cache_{tag}_{workers}"
            run(f"cache-images {tag} --workers {workers}",
                ["cache-images", "--image-dir", directory, "--out", cache, "--projections-csv",
                 csv_path, "--image-size", "224", "--workers", str(workers)])
            rates[(tag, workers)] = len(names) / walls[f"cache-images {tag} --workers {workers}"]
            with open(f"{cache}/cache_meta.json") as f:
                meta = json.load(f)
            caches[(tag, workers)] = (meta["channels"],
                                      np.fromfile(f"{cache}/images.u8", np.uint8))
    ref_cache = caches[("twin", 8)]
    equal = all(c[0] == ref_cache[0] and np.array_equal(c[1], ref_cache[1])
                for c in caches.values())
    print(f"  cache-images (224, {ref_cache[0]} channel(s)) on this host: "
          + ", ".join(f"{tag} --workers {k} {v:.1f} img/s" for (tag, k), v in rates.items())
          + f"; the four caches byte-equal: {equal}")
    if not equal:
        failures.append("(b) the JPEG layout's cache differs from its PNG twin's")
    kernels = ["--flash-attention", "--bert-fused-mlp"]
    probs = {}
    for tag, (csv_path, directory) in layouts.items():
        run(f"zeroshot {tag}",
            ["zeroshot", "--reports-csv", f"{work9}/labeled.csv", "--projections-csv", csv_path,
             "--image-dir", directory, "--image-cache", f"{w}/cache_{tag}_8", "--vocab",
             f"{work9}/vocab.txt", *kernels, "--checkpoint", f"{work9}/pretrain", "--log-dir",
             f"{w}/zs_{tag}"], f"cli_zeroshot_{tag}")
        with open(f"{w}/zs_{tag}/zero_shot_results.csv", newline="") as f:
            table = list(csv.reader(f))
        cols = [i for i, h in enumerate(table[0]) if h.startswith(("prob/", "true/"))]
        probs[tag] = [[row[i] for i in cols] for row in table[1:]]
    bit_equal = probs["jpeg"] == probs["twin"] and len(probs["jpeg"]) > 0
    print(f"  zeroshot over each ({len(probs['jpeg'])} exams, the pretrain checkpoint of phase 9): "
          f"probabilities bit-equal: {bit_equal}; {walls['zeroshot jpeg']:.1f} s and "
          f"{walls['zeroshot twin']:.1f} s; launches {by_path['cli_zeroshot_jpeg']}")
    if not bit_equal:
        failures.append("(b) zeroshot over the JPEGs differs from over their PNG twin")

    # -- (c) serving JPEG and BMP bodies ------------------------------------------------------
    vocab, ad = f"{work9}/vocab.txt", f"{work9}/adapter"
    thresholds = f"{work9}/zs_dyn/thresholds.json"
    tok = BertTokenizer(vocab, do_lower_case=False)
    cfg = cli._apply_tiny(get_preset("zero_shot"), argparse.Namespace(
        flash_attention=True, bert_fused_mlp=True), len(tok.vocab))
    size = cfg.model.image_size
    raw = []  # (format, bytes, cv2's decode, the PNG twin's bytes)
    for fmt, i in bodies:
        with open(cases[i]["path"], "rb") as f:
            data = f.read()
        rgb = np.load(cases[i]["decoded"])
        raw.append((fmt, data, rgb, encode_png(rgb[..., 0] if cases[i]["c"] == 1 else rgb)))
    for fmt, data, rgb, _ in raw:
        got = decode_image(data)
        if got is None or not np.array_equal(got, rgb):
            failures.append(f"(c) a {fmt} body's decode differs from cv2's")
    decoded = [decode_request_image(data, "image/jpeg", size) for _, data, _, _ in raw]
    refused = {}
    with open(cases[-1]["path"], "rb") as f:
        refused[cases[-1]["name"]] = f.read()
    # TIFF decodes since phase 21's slice; a CMYK one stays refused
    refused["refusedtiff-cmyk"] = encode_tiff(np.zeros((64, 64, 4), np.uint8), photometric=5)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if dev.type == "cuda":
        env.pop("CLIP_FOR_DL_TPU_FORCE_CPU", None)
    t = time.perf_counter()
    served = Served(["serve", "--vocab", vocab, *kernels, "--checkpoint", ad, "--thresholds",
                     thresholds, "--host", "127.0.0.1", "--port", "0", "--max-pending", "8",
                     "--log-dir", f"{w}/serve_logs"], f"{w}/launches_serve.json", env)
    start_s = time.perf_counter() - t
    jpegs = [k for k, r in enumerate(raw) if r[0] == ".jpg"]
    ctypes_of = {".jpg": "image/jpeg", ".bmp": "image/bmp"}
    try:
        answers, twins, seq = [], [], {}
        for k, (fmt, data, _, png) in enumerate(raw):
            answers.append(served.request("POST", "/predict", data, ctypes_of[fmt]))
            twins.append(served.request("POST", "/predict", png))
        for kind in ("jpeg", "png"):
            t0 = time.perf_counter()
            for _ in range(JPEG_SERVE_ROUNDS):
                for k in jpegs:
                    served.request("POST", "/predict", *((raw[k][1], "image/jpeg")
                                                         if kind == "jpeg" else (raw[k][3],)))
            seq[kind] = JPEG_SERVE_ROUNDS * len(jpegs) / (time.perf_counter() - t0)
        conc = {}
        for kind in ("jpeg", "png"):
            got = [None] * (JPEG_SERVE_CLIENTS * JPEG_SERVE_PER_CLIENT)

            def client(c):
                for j in range(JPEG_SERVE_PER_CLIENT):
                    k = jpegs[(c + j) % len(jpegs)]
                    body = (raw[k][1], "image/jpeg") if kind == "jpeg" else (raw[k][3],)
                    got[c * JPEG_SERVE_PER_CLIENT + j] = served.request("POST", "/predict",
                                                                        *body)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(JPEG_SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            conc[kind] = (len(got) / (time.perf_counter() - t0), got)
        odd = {name: served.request("POST", "/predict", data, "application/octet-stream")
               for name, data in refused.items()}
    finally:
        rc = served.stop()
    with open(f"{w}/launches_serve.json") as f:
        by_path["cli_serve_jpeg"] = json.load(f)
    check(rc == 0, f"serve exited with {rc} on SIGINT: {''.join(served.lines[-20:])}")
    check_launched(mods, by_path["cli_serve_jpeg"], "cli_serve_jpeg")
    statuses = [a[0] for a in answers + twins] + [g[0] for _, got in conc.values() for g in got]
    check(all(s == 200 for s in statuses), f"phase 20 (c): statuses {sorted(set(statuses))}")
    for name, (st, _, payload, _) in odd.items():
        if not (st == 400 and "A2c" in payload.get("error", "")):
            failures.append(f"(c) {name}: {st} {payload}")
    twin_equal = all(a[2]["probs"] == t_[2]["probs"] for a, t_ in zip(answers, twins))
    if not twin_equal:
        failures.append("(c) an answer differs from its PNG twin's")
    # At random weights the answers of different images lie closer together
    # than the bf16 route's difference, so the 5e-3 against the plain route
    # cannot tell one image from another. Two holds can: each answer (one
    # request alone, bucket 1) against this process's engine on the kernels
    # at batch 1 on its decoded pixels, the same kernels on the same shapes
    # (phase 10's "service"); and the image half, unit image features (B2 and
    # the tower) against the plain route, both below their spreads over
    # images.
    model = load_trained_model(ad, cfg, torch.bfloat16, device=dev)
    engine = ZeroShotEngine(model, tok, DISEASE_LABELS, cfg.zeroshot, cfg.augment.mean,
                            cfg.augment.std, size, cfg.model.max_text_length, torch.bfloat16)
    prep = mods["image_prep"]

    def unit_features():
        """Unit image features of every body, normalized in fp32 (phase 8's)."""
        out = []
        with torch.inference_mode():
            for i in range(0, len(decoded), 8):
                x = prep.preprocess_images(torch.from_numpy(np.stack(decoded[i:i + 8])).to(dev),
                                           size, size, cfg.augment.mean, cfg.augment.std)
                f = model.encode_image(x).float()
                out.append((f / f.norm(dim=-1, keepdim=True)).cpu().numpy())
        return np.concatenate(out)

    engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
    alone = np.concatenate([engine.probs(d[None]) for d in decoded])
    feats = unit_features()
    with plain_kernels(mods):
        before = dict(_build.LAUNCHES)
        engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
        want = np.concatenate([engine.probs(np.stack(decoded[i:i + 8]))
                               for i in range(0, len(decoded), 8)])
        plain_feats = unit_features()
        check(dict(_build.LAUNCHES) == before, "a kernel ran on the plain route")
    got = np.array([[a[2]["probs"][d] for d in DISEASE_LABELS] for a in answers])
    held("phase 20 (c): each JPEG and BMP answer against the engine on the kernels, alone, "
         "on its decoded pixels", got, alone, TOL["service"], {"images": apart(alone)},
         failures)
    held("phase 20 (c): the bodies' unit image features (B2, the tower) against the plain "
         "route", feats, plain_feats, TOL["served_image_features"],
         {"images": apart(plain_feats)}, failures)
    held("phase 20 (c): each JPEG and BMP answer against the plain route on its decoded "
         "pixels", got, want, TOL["probs_vs_plain"], {"images": apart(want)}, failures,
         bound=False)
    del engine, model
    torch.cuda.empty_cache()
    ms = {kind: [g[3] * 1e3 for g in conc[kind][1]] for kind in conc}
    print(f"phase 20 (c): serve (zero_shot, {describe(cfg.model)}, bf16, phase 9's adapter "
          f"checkpoint) up in {start_s:.1f} s; {len(raw)} JPEG and BMP bodies (224x224x3 and "
          f"{JPEG_BODY_SIDE}x{JPEG_BODY_SIDE} grey) decode byte-equal to cv2; answered 200, each bit-equal to its PNG "
          f"twin's: {twin_equal}; WebP and CMYK TIFF: "
          + ", ".join(f"{o[0]} ({o[2].get('error', '')[:60]!r})" for o in odd.values()))
    print(f"  on {card}, JPEG bodies beside their PNG twins: one by one "
          f"{seq['jpeg']:.1f} vs {seq['png']:.1f} req/s; {JPEG_SERVE_CLIENTS} clients x "
          f"{JPEG_SERVE_PER_CLIENT}: {conc['jpeg'][0]:.1f} vs {conc['png'][0]:.1f} req/s, "
          f"client p50 {pct(ms['jpeg'], 50):.1f} vs {pct(ms['png'], 50):.1f} ms, p99 "
          f"{pct(ms['jpeg'], 99):.1f} vs {pct(ms['png'], 99):.1f} ms; launches "
          f"{by_path['cli_serve_jpeg']}")
    check(not failures, "phase 20: " + "; ".join(failures))
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


# -- phase 21: TIFF and Netpbm (ROADMAP A2c, second part) ----------------------------------

TIFF_TIMED = 5  # decodes each phase-21 time is the median of
TIFF_SERVE_ROUNDS = 16  # phase 21 (c)'s requests of each body one by one
TIFF_SERVE_CLIENTS, TIFF_SERVE_PER_CLIENT = 8, 32  # phase 21 (c)'s concurrent pass

def tiff_pnm_phase21(_build, mods, dev, seed: int, card: str, workdir: str,
                     results: dict) -> dict:
    """Phase 21: TIFF and Netpbm decoding (ROADMAP A2c, second part), on
    phase 8's layout and phases 9's and 20's files in ``workdir``; returns
    the launches of its paths. cv2 runs in a child process (CV2_CHILD) as
    the yardstick the port never calls; the phase fails without it."""
    import argparse
    import importlib
    import io
    import os
    import threading
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    cli = importlib.import_module("clip_for_dl_tpu_torch.cli.main")
    from clip_for_dl_tpu_torch.core.config import DISEASE_LABELS, get_preset
    from clip_for_dl_tpu_torch.data.frame import read_csv
    from clip_for_dl_tpu_torch.inference import load_trained_model
    from clip_for_dl_tpu_torch.native import decode_image, decoder
    from clip_for_dl_tpu_torch.serving import decode_request_image
    from clip_for_dl_tpu_torch.testing.png import encode_png
    from clip_for_dl_tpu_torch.testing.tiff import encode_tiff
    from clip_for_dl_tpu_torch.text import BertTokenizer
    from clip_for_dl_tpu_torch.zeroshot import ZeroShotEngine, prompts_for_family

    t_phase = time.perf_counter()
    kaggle, work9, w = f"{workdir}/kaggle", f"{workdir}/cli", f"{workdir}/phase21"
    for d in ("cases", "tiff", "pgm"):
        os.makedirs(f"{w}/{d}")
    by_path, failures, walls = {}, [], {}

    # -- the yardstick's files: (a)'s cases, (c)'s bodies, (b)'s layout ---------------------
    cases, side = [], JPEG_BODY_SIDE

    def case(name, ext, timed=False, **spec):
        cases.append({"name": name, "path": f"{w}/cases/{name}{ext}", "timed": timed,
                      "decoded": f"{w}/cases/{name}.npy", "read": f"{w}/cases/{name}.read.npy",
                      **spec})

    def written(name, fmt, h, w_, c, bits, compression=None, timed=False):
        case(name, fmt if fmt.startswith(".") else ".tif", timed, fmt=fmt, h=h, w=w_, c=c,
             bits=bits, seed=len(cases) + seed,
             params=[["IMWRITE_TIFF_COMPRESSION", compression]] if compression else [])

    lzw, deflate = 5, 8
    written(f"tiff-lzw-grey16-{side}", ".tiff", side, side, 1, 16, lzw, True)
    written(f"tiff-deflate-grey16-{side}", ".tiff", side, side, 1, 16, deflate, True)
    written(f"pgm-grey16-{side}", ".pgm", side, side, 1, 16, timed=True)
    written("tiff-lzw-rgb8-224", ".tiff", 224, 224, 3, 8, lzw)
    written("tiff-lzw-rgb16-224", ".tiff", 224, 224, 3, 16, lzw)
    written("tiff-packbits-bgra8-224", ".tiff", 224, 224, 4, 8, 32773)
    written("tiff-none-grey8-224", ".tiff", 224, 224, 1, 8, 1)
    written("ppm-224", ".ppm", 224, 224, 3, 8)
    written("pgm-grey8-224", ".pgm", 224, 224, 1, 8)
    written("pbm-224", ".pbm", 224, 224, 1, 8)
    written("pam-rgb-224", ".pam", 224, 224, 3, 8)
    written("tiff-jpeg-rgb-224", "pil-jpeg-tiff", 224, 224, 3, 8)
    # what cv2 does not write, from the port's test writer
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(np.cumsum(rng.integers(-9, 10, (300, 260)), 0), 1)
    grey16 = ((smooth - smooth.min()) * 65535 // max(1, int(np.ptp(smooth)))).astype(np.uint16)
    grey8 = (grey16 >> 8).astype(np.uint8)
    rgb8 = np.stack([grey8, np.roll(grey8, 5, 0), np.roll(grey8, 9, 1)], -1)
    given = {
        "tiff-tiles-grey16-lzw-bigendian": encode_tiff(grey16, bps=16, compression=5,
                                                       predictor=2, tile=(64, 64), order=">"),
        "tiff-bigtiff-planar-rgb-deflate": encode_tiff(rgb8, compression=8, planar=2, big=True,
                                                       rows_per_strip=32),
        "tiff-old-lzw-palette": encode_tiff(grey8 >> 4, bps=4, photometric=3, compression=5,
                                            old_lzw=True,
                                            colormap=rng.integers(0, 65536, (16, 3))),
        "tiff-orientation6-grey8": encode_tiff(grey8, orientation=6, compression=5),
    }
    for name, data in given.items():
        case(name, ".tif")
        with open(cases[-1]["path"], "wb") as f:
            f.write(data)
    refused = {"CMYK TIFF": encode_tiff(np.dstack([rgb8, grey8])[:64, :64], photometric=5),
               "Group 4 TIFF": encode_tiff(grey8[:64, :64] > 128, bps=1, tags={259: (3, [4])})}
    no_image = encode_tiff(grey16[:64, :64].astype(np.uint32), bps=32, sample_format=3)
    projections = read_csv(f"{kaggle}/indiana_projections.csv")
    names = [str(n) for n in projections.column("filename")]
    image_dir = f"{kaggle}/images/images_normalized"
    renamed = {ext: {n: n[:-4] + ext for n in names} for ext in (".tif", ".pgm")}
    layout = [{"src": f"{image_dir}/{n}", "big": None, "bits": 16, "seed": i, "outputs": [
        [f"{w}/tiff/{renamed['.tif'][n]}", ".tiff", [["IMWRITE_TIFF_COMPRESSION", lzw]], None],
        [f"{w}/pgm/{renamed['.pgm'][n]}", ".pgm", [], None]]} for i, n in enumerate(names)]
    with open(f"{w}/task.json", "w") as f:
        json.dump({"cases": cases, "layout": layout, "timed": TIFF_TIMED}, f)
    t = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", CV2_CHILD, f"{w}/task.json",
                            f"{w}/cv2.json"], capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"phase 21's cv2 child failed ({child.returncode}): "
          f"{child.stderr[-3000:]}")
    with open(f"{w}/cv2.json") as f:
        yard = json.load(f)
    print(f"cv2 {yard['cv2']} (a child process, the yardstick): TIFF {yard['libs']['TIFF']!r}; wrote "
          f"{len(cases) - len(given) - len(yard['skipped'])} images (could not: "
          f"{yard['skipped'] or 'none'}) and {len(layout)} layout files as 16-bit grey LZW "
          f"TIFF and PGM in {time.perf_counter() - t:.1f} s")

    # -- (a) the decoder on this machine ----------------------------------------------------
    t = time.perf_counter()
    log = decoder.compile_library(Path(f"{w}/libcxr_decode-fresh.so"))
    build_s = time.perf_counter() - t
    decoder.library()
    print(f"phase 21 (a): the decoder built with g++ {' '.join(decoder.CXX_FLAGS)} in "
          f"{build_s:.1f} s from {', '.join(str(s.relative_to(ROOT)) for s in decoder.SOURCES)} "
          f"and {' '.join(decoder.LIBS)}"
          + (f" ({log.strip()[:200]})" if log.strip() else ""))

    def equal(got, path):
        want = np.load(path) if os.path.exists(path) else None
        return (got is None) == (want is None) and (
            got is None or (got.shape == want.shape and np.array_equal(got, want)))

    timed = {}
    for c in cases:
        if c["name"] in yard["skipped"]:
            continue
        with open(c["path"], "rb") as f:
            data = f.read()
        got, got_file = decode_image(data), decode_image(data, file=True)
        same = equal(got, c["decoded"]) and equal(got_file, c["read"])
        print(f"  {c['name']}: {len(data)} bytes -> {None if got is None else got.shape} "
              f"(as a file {None if got_file is None else got_file.shape}), byte-equal to "
              f"cv2.imdecode and cv2.imread: {same}")
        if not same:
            failures.append(f"(a) {c['name']}: the port's decode differs from cv2's")
        if c["timed"]:
            times = []
            for _ in range(TIFF_TIMED):
                t0 = time.perf_counter()
                decoder.decode(data)
                times.append((time.perf_counter() - t0) * 1e3)
            timed[c["name"]] = float(np.median(times))
    print(f"  decode ms (median of {TIFF_TIMED}, one thread) on the host of {card}, the "
          "port's C++ beside cv2.imdecode: " + "; ".join(
              f"{k} {v:.2f} vs {yard['ms'][k]:.2f}" for k, v in timed.items()))

    # -- (b) files: the layout as 16-bit TIFF and PGM, and the layout's own PNGs ----------
    def run(name, argv, path=None, stack=None):
        out = io.StringIO()
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        with redirect_stdout(out), (stack or ExitStack()):
            rc = cli.main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        check(rc == 0, f"{name} exited with {rc}: {out.getvalue()[-2000:]}")
        if path:
            by_path[path] = dict(_build.LAUNCHES)
            check_launched(mods, by_path[path], path)
        torch.cuda.empty_cache()

    with open(f"{kaggle}/indiana_projections.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    layouts = {"png": (f"{kaggle}/indiana_projections.csv", image_dir, f"{work9}/cache")}
    for tag, ext in (("tiff", ".tif"), ("pgm", ".pgm")):
        with open(f"{w}/{tag}_projections.csv", "w", newline="") as f:
            out = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
            out.writeheader()
            out.writerows({**r, "filename": renamed[ext][r["filename"]]} for r in rows)
        layouts[tag] = (f"{w}/{tag}_projections.csv", f"{w}/{tag}", f"{w}/cache_{tag}")
        run(f"cache-images {tag}", ["cache-images", "--image-dir", layouts[tag][1], "--out",
                                    layouts[tag][2], "--projections-csv", layouts[tag][0],
                                    "--image-size", "224", "--workers", "8"])
    caches = {}
    for tag, (_, _, cache) in layouts.items():
        with open(f"{cache}/cache_meta.json") as f:
            caches[tag] = (json.load(f)["channels"], np.fromfile(f"{cache}/images.u8", np.uint8))
    equal_caches = all(c[0] == caches["png"][0] and np.array_equal(c[1], caches["png"][1])
                       for c in caches.values())
    print(f"phase 21 (b): cache-images (224, --workers 8) on the host of {card}: "
          + ", ".join(f"{tag} {len(names) / walls[f'cache-images {tag}']:.1f} img/s"
                      for tag in ("tiff", "pgm"))
          + f"; both byte-equal to phase 9's cache of the layout's PNGs: {equal_caches}")
    if not equal_caches:
        failures.append("(b) a TIFF or PGM layout's cache differs from the PNGs'")
    kernels = ["--flash-attention", "--bert-fused-mlp"]
    probs = {}
    which = dict.fromkeys(("similarity", "image_prep", "flash_attention", "mlp"))
    for tag, (csv_path, directory, cache) in layouts.items():
        stack, kept = first_inputs(mods, which) if tag == "tiff" else (None, None)
        run(f"zeroshot {tag}",
            ["zeroshot", "--reports-csv", f"{work9}/labeled.csv", "--projections-csv", csv_path,
             "--image-dir", directory, "--image-cache", cache, "--vocab", f"{work9}/vocab.txt",
             *kernels, "--checkpoint", f"{work9}/pretrain", "--log-dir", f"{w}/zs_{tag}"],
            f"cli_zeroshot_{tag}21", stack)
        if kept is not None:
            hold_first_inputs(mods, kept, which, "zeroshot over the TIFF layout", results)
        with open(f"{w}/zs_{tag}/zero_shot_results.csv", newline="") as f:
            table = list(csv.reader(f))
        cols = [i for i, h in enumerate(table[0]) if h.startswith(("prob/", "true/"))]
        probs[tag] = [[row[i] for i in cols] for row in table[1:]]
    bit_equal = probs["tiff"] == probs["pgm"] == probs["png"] and len(probs["png"]) > 0
    print(f"  zeroshot over each ({len(probs['png'])} exams, phase 9's pretrain checkpoint): "
          f"probabilities bit-equal: {bit_equal}; "
          + ", ".join(f"{tag} {walls[f'zeroshot {tag}']:.1f} s" for tag in layouts)
          + f"; launches {by_path['cli_zeroshot_tiff21']}")
    if not bit_equal:
        failures.append("(b) zeroshot over the TIFF or PGM layout differs from over the PNGs")

    # -- (c) serving TIFF and PGM bodies beside JPEG and BMP ones --------------------------
    vocab, ad = f"{work9}/vocab.txt", f"{work9}/adapter"
    tok = BertTokenizer(vocab, do_lower_case=False)
    cfg = cli._apply_tiny(get_preset("zero_shot"), argparse.Namespace(
        flash_attention=True, bert_fused_mlp=True), len(tok.vocab))
    size = cfg.model.image_size
    served_names = [f"tiff-lzw-grey16-{side}", f"tiff-deflate-grey16-{side}",
                    f"pgm-grey16-{side}", "tiff-lzw-rgb8-224", "ppm-224"]
    paths = {c["name"]: c["path"] for c in cases if c["name"] in served_names}
    for fmt in ("jpg", "bmp"):  # phase 20's bodies of the same side
        paths[f"{fmt}-grey8-{side}"] = f"{workdir}/phase20/cases/body0-{side}{fmt}.{fmt}"
    raw = []  # (name, bytes, the PNG twin of its decode)
    for name, path in paths.items():
        with open(path, "rb") as f:
            data = f.read()
        rgb = decode_image(data)
        raw.append((name, data, encode_png(rgb[..., 0] if (rgb == rgb[..., :1]).all() else rgb)))
    decoded = [decode_request_image(d, "image/tiff", size) for _, d, _ in raw]
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    if dev.type == "cuda":
        env.pop("CLIP_FOR_DL_TPU_FORCE_CPU", None)
    t = time.perf_counter()
    served = Served(["serve", "--vocab", vocab, *kernels, "--checkpoint", ad, "--thresholds",
                     f"{work9}/zs_dyn/thresholds.json", "--host", "127.0.0.1", "--port", "0",
                     "--max-pending", "8", "--log-dir", f"{w}/serve_logs"],
                    f"{w}/launches_serve.json", env)
    start_s = time.perf_counter() - t
    try:
        answers = [served.request("POST", "/predict", d, "image/tiff") for _, d, _ in raw]
        twins = [served.request("POST", "/predict", png) for _, _, png in raw]
        seq = {}  # name: (req/s, each request's ms)
        for name, data, _ in raw:
            t0 = time.perf_counter()
            each = [served.request("POST", "/predict", data, "image/tiff")[3] * 1e3
                    for _ in range(TIFF_SERVE_ROUNDS)]
            seq[name] = (TIFF_SERVE_ROUNDS / (time.perf_counter() - t0), each)
        big = [d for name, d, _ in raw if name.startswith(("tiff", "pgm")) and str(side) in name]
        got_conc = [None] * (TIFF_SERVE_CLIENTS * TIFF_SERVE_PER_CLIENT)

        def client(c):
            for j in range(TIFF_SERVE_PER_CLIENT):
                got_conc[c * TIFF_SERVE_PER_CLIENT + j] = served.request(
                    "POST", "/predict", big[(c + j) % len(big)], "image/tiff")

        threads = [threading.Thread(target=client, args=(c,)) for c in range(TIFF_SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        conc = len(got_conc) / (time.perf_counter() - t0)
        odd = {name: served.request("POST", "/predict", data, "image/tiff")
               for name, data in refused.items()}
        none_answer = served.request("POST", "/predict", no_image, "image/tiff")
    finally:
        rc = served.stop()
    with open(f"{w}/launches_serve.json") as f:
        by_path["cli_serve_tiff"] = json.load(f)
    check(rc == 0, f"serve exited with {rc} on SIGINT: {''.join(served.lines[-20:])}")
    check_launched(mods, by_path["cli_serve_tiff"], "cli_serve_tiff")
    statuses = [a[0] for a in answers + twins + got_conc]
    check(all(s == 200 for s in statuses), f"phase 21 (c): statuses {sorted(set(statuses))}")
    for name, (st, _, payload, _) in odd.items():
        if not (st == 400 and "A2c" in payload.get("error", "")):
            failures.append(f"(c) {name}: {st} {payload}")
    if not (none_answer[0] == 400 and "A2c" not in none_answer[2].get("error", "")):
        failures.append(f"(c) a float TIFF: {none_answer[0]} {none_answer[2]}")
    twin_equal = all(a[2]["probs"] == t_[2]["probs"] for a, t_ in zip(answers, twins))
    if not twin_equal:
        failures.append("(c) an answer differs from its PNG twin's")
    # the holds of phase 20 (c): each answer against this process's engine on
    # the kernels alone on its pixels, and the bodies' unit image features
    # (B2 and the tower) against the plain route, each below its spread
    model = load_trained_model(ad, cfg, torch.bfloat16, device=dev)
    engine = ZeroShotEngine(model, tok, DISEASE_LABELS, cfg.zeroshot, cfg.augment.mean,
                            cfg.augment.std, size, cfg.model.max_text_length, torch.bfloat16)
    prep = mods["image_prep"]

    def unit_features():
        with torch.inference_mode():
            x = prep.preprocess_images(torch.from_numpy(np.stack(decoded)).to(dev), size, size,
                                       cfg.augment.mean, cfg.augment.std)
            f = model.encode_image(x).float()
            return (f / f.norm(dim=-1, keepdim=True)).cpu().numpy()

    engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
    alone = np.concatenate([engine.probs(d[None]) for d in decoded])
    feats = unit_features()
    with plain_kernels(mods):
        before = dict(_build.LAUNCHES)
        engine.build_text_features(prompts_for_family("prediction", DISEASE_LABELS))
        want = engine.probs(np.stack(decoded))
        plain_feats = unit_features()
        check(dict(_build.LAUNCHES) == before, "a kernel ran on the plain route")
    got = np.array([[a[2]["probs"][d] for d in DISEASE_LABELS] for a in answers])
    held("phase 21 (c): each TIFF, PGM, PPM, JPEG and BMP answer against the engine on the "
         "kernels, alone, on its decoded pixels", got, alone, TOL["service"],
         {"images": apart(alone)}, failures)
    held("phase 21 (c): the bodies' unit image features (B2, the tower) against the plain "
         "route", feats, plain_feats, TOL["served_image_features"],
         {"images": apart(plain_feats)}, failures)
    held("phase 21 (c): each answer against the plain route on its decoded pixels", got, want,
         TOL["probs_vs_plain"], {"images": apart(want)}, failures, bound=False)
    del engine, model
    torch.cuda.empty_cache()
    ms = [g[3] * 1e3 for g in got_conc]
    print(f"phase 21 (c): serve (zero_shot, {describe(cfg.model)}, bf16, phase 9's adapter "
          f"checkpoint) up in {start_s:.1f} s; {len(raw)} bodies ({', '.join(paths)}) "
          f"answered 200, each bit-equal to its PNG twin's: "
          f"{twin_equal}; "
          + ", ".join(f"{name} {o[0]} ({o[2].get('error', '')[:60]!r})" for name, o in odd.items())
          + f"; a float TIFF {none_answer[0]} ({none_answer[2].get('error', '')!r})")
    print(f"  on {card}, one by one ({TIFF_SERVE_ROUNDS} requests each; req/s, client p50 "
          "and p90 ms): " + ", ".join(f"{k} {r:.2f} ({pct(e, 50):.1f}, {pct(e, 90):.1f})"
                                      for k, (r, e) in seq.items())
          + f"; {TIFF_SERVE_CLIENTS} clients x {TIFF_SERVE_PER_CLIENT} over the {side}x{side} "
          f"TIFF and PGM bodies: {conc:.1f} req/s, client p50 {pct(ms, 50):.1f} ms, p99 "
          f"{pct(ms, 99):.1f} ms; launches {by_path['cli_serve_tiff']}")
    check(not failures, "phase 21: " + "; ".join(failures))
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    ap.add_argument("--first-step-seeds", type=int, nargs="+", metavar="SEED",
                    help="only build the kernels and print the readings of first_step_sweep "
                         "at these seeds")
    ap.add_argument("--train-first-step-seeds", type=int, nargs="+", metavar="SEED",
                    help="only build the kernels and print the readings of "
                         "train_first_step_sweep at these seeds")
    ap.add_argument("--gradcam-seeds", type=int, nargs="+", metavar="SEED",
                    help="only build the kernels and print the readings of gradcam_sweep "
                         "at these seeds")
    ap.add_argument("--phase15-rank", metavar="DIR",
                    help="(under torchrun, as phase 15 starts it) one rank of phase 15 on "
                         "the files of phases 9 and 15 beside DIR")
    ap.add_argument("--phase16-rank", metavar="DIR",
                    help="(under torchrun, as phase 16 starts it) one rank of phase 16 on "
                         "the files of phases 9 and 16 beside DIR")
    ap.add_argument("--phase17-rank", metavar="DIR",
                    help="(under torchrun, as phase 17 starts it) one rank of phase 17 on "
                         "the files of phase 9 beside DIR")
    ap.add_argument("--phase18-rank", metavar="DIR",
                    help="(under torchrun, as phase 18 starts it) one rank of phase 18 on "
                         "the files of phase 9 beside DIR")
    ap.add_argument("--phase19-rank", metavar="DIR",
                    help="(under torchrun, as phase 19 starts it) one rank of phase 19 on "
                         "the files of phase 9 beside DIR")
    args = ap.parse_args(argv)
    if args.phase15_rank:
        return phase15_rank(args.phase15_rank, args.seed)
    if args.phase16_rank:
        return phase16_rank(args.phase16_rank, args.seed)
    if args.phase17_rank:
        return phase17_rank(args.phase17_rank, args.seed)
    if args.phase18_rank:
        return phase18_rank(args.phase18_rank, args.seed)
    if args.phase19_rank:
        return phase19_rank(args.phase19_rank, args.seed)

    t_start = time.perf_counter()
    _build, mods = import_port()
    import torch

    from clip_for_dl_tpu_torch.core.device import require_cuda

    try:
        dev = require_cuda("cuda:0")
    except RuntimeError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn tf32 {torch.backends.cudnn.allow_tf32}")
    print(f"host probe: {host_probe()}")

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    if args.first_step_seeds:
        first_step_sweep(_build, mods, dev, args.first_step_seeds)
        return 0
    if args.train_first_step_seeds:
        train_first_step_sweep(_build, mods, dev, args.train_first_step_seeds)
        return 0
    if args.gradcam_seeds:
        gradcam_sweep(_build, mods, dev, args.gradcam_seeds)
        return 0
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")
    counts = tensor_core_counts(_build)
    # the 16-bit attention bodies, templated on their type (the mangled
    # names' "13__nv_bfloat16" and "6__half")
    for t, mangled in (("bf16", "I13__nv_bfloat16"), ("fp16", "I6__half")):
        for kernel in ("flash_fwd_kernel", "flash_bwd_rows_kernel", "flash_bwd_cols_kernel"):
            for d in (32, 64, 128):
                n = sum(c[0] + c[1] for name, c in counts.items()
                        if kernel in name and f"{mangled}Li{d}E" in name)
                print(f"tensor-core instructions (HMMA/HGMMA) in {kernel}<{t}, {d}>: {n}")
                check(n > 0, f"{kernel}<{t}, {d}> has no tensor-core instruction")
        for kernel in ("flash_fwd_sliced_kernel", "flash_bwd_rows_sliced_kernel",
                       "flash_bwd_cols_sliced_kernel"):
            n = sum(c[0] + c[1] for name, c in counts.items()
                    if kernel in name and f"{mangled}E" in name)
            print(f"tensor-core instructions (HMMA/HGMMA) in {kernel}<{t}>: {n}")
            check(n > 0, f"{kernel}<{t}> has no tensor-core instruction")
    # the fp32 attention bodies run on the CUDA cores
    for kernel in ("flash_fwd_f32_kernel", "flash_bwd_rows_f32_kernel",
                   "flash_bwd_cols_f32_kernel"):
        found = [name for name in counts if kernel in name]
        check(len(found) == 1, f"{kernel}: {len(found)} instances in the library")
    # B8a in both GELU forms (its template parameter), B8b once
    for kernel, instances in (("mlp_bwd_gelu_kernel", 2), ("mlp_bwd_dx_kernel", 1)):
        found = [c for name, c in counts.items() if kernel in name]
        for hmma, hgmma in found:
            print(f"B8 {kernel}: HGMMA {hgmma}, HMMA {hmma}")
        check(len(found) == instances and all(hgmma > 0 for _, hgmma in found),
              f"{kernel}: {len(found)} instances, HGMMA {[c[1] for c in found]}")
    for which, epilogue in (("B4", "Dense"), ("B9", "MlpBlock")):
        for kernel in ("mlp_fwd_gelu_kernel", "mlp_fwd_out_kernel"):
            found = [c for name, c in counts.items() if kernel in name and epilogue in name]
            hmma, hgmma = (sum(c[i] for c in found) for i in (0, 1))
            print(f"{which} {kernel}: HGMMA {hgmma}, HMMA {hmma}")
            check(len(found) == 1 and hgmma > 0 and hmma == 0,
                  f"{which} {kernel}: {len(found)} instances, HGMMA {hgmma}, HMMA {hmma}")

    results: dict = {}
    phase2(mods, dev, args.seed, BATCH, results)
    phase2_train(mods, dev, args.seed, results)
    phase2_tanh(mods, dev, args.seed, results)
    phase2_repairs(mods, dev, args.seed, results)
    by_path = phase2_split(_build, mods, dev, args.seed, results)
    phase2_limits(mods, dev, args.seed, results)
    print("== phase 2, C7: attention in fp32 and fp16")
    phase2_types(mods, dev, args.seed, results)
    by_path["typed_attention"] = typed_attention_path(_build, mods, dev, args.seed)
    print("== phase 2, C8: B1 and B2 on every input the JAX kernels take")
    by_path["c8_cases"] = phase2_c8(_build, mods, dev, args.seed, results)
    print("== phase 3: zero-shot serving, ResNet-50")
    by_path["serve"] = serve_phase(_build, mods, dev, args.seed, BATCH, N_BATCHES, card, "serve")
    print("== phase 4: the phase-A train step")
    readings: dict = {}
    by_path["train"] = phase4(_build, mods, dev, args.seed, card, readings)
    print("== phase 5: zero-shot serving, ViT-B/16")
    by_path["serve_vit"] = serve_phase(_build, mods, dev, args.seed, BATCH, N_BATCHES, card,
                                       "serve_vit")
    with tempfile.TemporaryDirectory(prefix="smoke_") as workdir:
        print("== phase 6: the chain pretrain -> adapter")
        by_path.update(phase6(_build, mods, dev, args.seed, card, workdir))
        print("== phase 7: the parity mode, --fp32 --flash-attention")
        by_path["serve_fp32"] = serve_fp32_phase(_build, mods, dev, args.seed, card)
        by_path["train_fp32"] = train_fp32_phase(_build, mods, dev, args.seed)
        print("== phase 8: evaluation from files")
        by_path.update(eval_files_phase(_build, mods, dev, args.seed, card, workdir,
                                        results))
        print("== phase 9: the chain from the command line")
        by_path.update(cli_phase(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 10: serve, the report-built banks, the rest of the pretrain options")
        by_path.update(serve_phase10(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 11: the scripts' multi-view training, the multimodal zero-shot, the "
              "shared adapter")
        by_path.update(train_phase11(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 12: ViT training with the tanh GELU, LoRA")
        by_path.update(vit_lora_phase12(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 13: Grad-CAM and attention rollout")
        by_path.update(interpret_phase13(_build, mods, dev, args.seed, card, workdir,
                                         results))
        print("== phase 14: export, serve --exported")
        by_path.update(export_phase14(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 15: data parallelism over NCCL, one rank a card (torchrun)")
        by_path.update(dp_phase15(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 16: tensor and sequence parallelism, serving over a group")
        by_path.update(tp_phase16(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 17: the Switch-MoE text tower, routing over a group, expert "
              "parallelism")
        by_path.update(moe_phase17(_build, mods, dev, args.seed, card, workdir, results,
                                   readings))
        print("== phase 18: pipeline parallelism, every stage on one card, and over NCCL")
        by_path.update(pp_phase18(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 19: --remat, --bf16-attention-probs, every command over a group")
        by_path.update(remat_phase19(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 20: decoding JPEG and BMP: the decoder, evaluation from JPEG files, "
              "serve")
        by_path.update(jpeg_phase20(_build, mods, dev, args.seed, card, workdir, results))
        print("== phase 21: decoding TIFF and Netpbm: the decoder, evaluation from 16-bit TIFF "
              "and PGM files, serve")
        by_path.update(tiff_pnm_phase21(_build, mods, dev, args.seed, card, workdir, results))
    print("== the wrappers' host time (tools/launch_times.py)")
    from clip_for_dl_tpu_torch.tools import launch_times

    check(launch_times.main(["--root", str(ROOT), "--requests", "10"]) == 0,
          "launch_times failed")

    kernels = []
    for name, (key, src, tpu) in KERNELS.items():
        counts = {path: launches.get(key, 0) for path, launches in by_path.items()}
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": tpu,
                        "launches": sum(counts.values()), "launches_by_path": counts,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    print(f"smoke took {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.exit(code)
