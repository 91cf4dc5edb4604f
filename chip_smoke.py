"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final result line:
  1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel under faceposegenerator_tpu_torch/csrc, with nvcc,
     and what ptxas reported for each kernel function (registers, spill
     bytes, any "Performance Loss" line; the wgmma kernels' registers and
     spills also go into their entries of the kernels line), and the count
     of HGMMA instructions, and of those with TF32 operands, in each fp32
     attention kernel and K4's fp32 instance (`cuobjdump -sass`; into their
     entries too; a fp32 kernel with an HGMMA that is not TF32 fails); per
     instance of K7's and K8's kernels, the IGMMA, IMMA, conversion and MUFU
     counts (a GEMM or attention instance without IGMMA, or any IMMA, fails);
     per instance of the backward attention kernels (K5, K6), the HGMMA and
     HMMA counts (an instance without HGMMA, or with any HMMA, fails);
  3. kernels against plain: each kernel at every shape the main paths give
     it, bf16 unit-normal inputs from a seed, against its plain PyTorch
     version in fp32 on the same inputs (max abs err <= 2e-2, mean <= 2e-3;
     for the backward kernels, of each gradient's max abs; the forward's
     log-sum-exp within 1e-3), timed beside that plain
     version, the PyTorch library call (`scaled_dot_product_attention`
     forward or its backward through autograd: a yardstick, used nowhere in
     the port) and the card's bound, with the rate (`tflops`: the FLOPs
     the bound counts over the measured time). The sampling shapes (K1, K2 forward)
     first, then the train shapes (K1, K2 with the log-sum-exp; K5, K6);
  4. txt2img: StableDiffusionPipeline.from_random at SD2.1-base widths in
     bf16 with a rank-4 UNet LoRA, first against its own plain-attention
     path on a small input, then 3 requests at batch 8, 512², 30 DDPM steps,
     CFG 5.0, swapping the LoRA before the third; each request must launch
     the d=64 kernel 960 times and the wide kernel once;
  5. K7 and K8 against plain: qdense (csrc/qdense.cu) in its dynamic and
     static modes at the turbo request's dense shapes, against qdense_plain
     on the same bf16 inputs (the same codes, so within 1 bf16 ulp of the
     output plus 1e-3 relative), timed beside its plain version, the card's
     bound, torch._int_mm on the pre-quantized x (the int8 GEMM alone) and
     bf16 F.linear (yardsticks the port never calls); in the wide instance
     its qdense_quant pass bit-exact against quantize() and timed alone; flash_int8
     (csrc/flash_int8.cu) at the UNet's attention shapes of the CFG batch
     against attention_int8_plain (it makes the same codes: within 1 bf16
     ulp + 1e-3 relative, mean abs err <= 1e-4) and, with q and k at half
     scale as the JAX test has them, within 3e-2 relative of exact
     attention, timed beside its plain version, its bound, K1 on the same
     tensors and SDPA; one more row puts every row's maximum in the last
     64 keys and shows that the gate refuses both exact attention and a
     softmax that quantizes p against a running max over 64-key tiles, and
     one more is the 640² self-attention (2 × 5 × 6400², two 4096-key
     blocks); at every row its flash_int8_amax and flash_int8_codes
     launches bit-exact against int8_codes_plain, each of the three
     launches timed alone (the attention on ready codes: `attend_ms`);
  6. turbo: the turbo preset at SD2.1-base widths in bf16 with a rank-4
     LoRA: first the kernel routes against the plain routes of qdense,
     flash_int8 and attention on 2×128² (image diff max 1e-1, mean 1e-2),
     then get_preset("turbo").apply (dpm, w8a8+vae, 8 calibration steps: 1280
     dynamic qdense launches, 400 of them in the wide instance after a
     qdense_quant launch), 3 requests at batch 8, 512², 12 DPM-Solver++
     steps (4 full UNet passes and 8 DeepCache partial ones: 1040 static
     qdense, 280 qdense_quant, 208 K1 launches and 1 K2 launch each), then 2 requests of
     the flash_int8 configuration (208 flash_int8, flash_int8_amax and
     flash_int8_codes launches each instead of K1);
  7. train: the ID-Booth train step at its op point (SD2.1-base widths,
     ArcFace r100, random bf16 frozen weights, fp32 rank-4 LoRA, batch 4
     with prior preservation = 8 images of 512², triplet_prior, AdamW +
     cosine + clip 1.0), first the kernel path against the plain-attention
     path on 2(+2) images of 128² (loss within 1e-2 relative, LoRA gradient
     cosine >= 0.99), then 3 train steps, each of which must launch K1 32,
     K2 2, and K5 and K6 32 and 1 times per pass, move the LoRA and leave
     the frozen weights untouched;
  8. K3 and K4 against plain: fused_group_norm (csrc/fused_gn.cu) at every
     GroupNorm shape K3 takes on the fused txt2img request and train step,
     against fused_group_norm_plain on the same bf16 inputs (each output
     within 1 bf16 ulp + 1e-3 relative + 1e-5 of the output's max abs),
     timed as a call (the wrapper: `ms`) and as a launch (its one C call on
     ready buffers: `launch_ms`), with the wrapper's host time a call
     (`host_us`), beside its plain version, the card's bound and
     F.group_norm (+ F.silu) on the channels_last NCHW view; gn_silu_conv3x3
     (csrc/gn_conv.cu) at every conv shape K4 takes there, against
     gn_silu_conv3x3_plain (within 1 bf16 ulp + 1e-3 of the output's max
     abs), timed beside its plain version, the bound and the default
     route's plain GroupNorm+SiLU and cuDNN conv (yardsticks the port never
     calls in this configuration), with its rate (`tflops`; the kernels
     line adds its ptxas registers and spills); one more K4 row with β + 3,
     on which a pad-before-activation variant must fail the gate;
  9. fused txt2img: GN_IMPL and GN_CONV_IMPL at pallas on a new pipeline as
     in phase 4, first against the default routes on 2×128² (image diff max
     1e-1, mean 1e-2), then 2 requests at batch 8, 512², 30 DDPM steps, CFG
     5.0, each launching exactly K4 480, K3 371, K1 960 and K2 1 times,
     their s/request beside phase 4's; then GN_IMPL alone at pallas (K4 left
     at xla: K3 is the only GroupNorm kernel, and takes K4's 480 norms too)
     on the same pipeline: against the default routes on 2×128² (the same
     limits), then 1 request launching exactly K3 851, K1 960 and K2 1
     times, its s/request beside the default's;
 10. fused train: the train step of phase 7's op point in that
     configuration, first against the default routes at 2(+2)×128² (loss
     within 1e-2 relative, LoRA gradient cosine >= 0.99), then 2 steps, each
     launching exactly K4 16 and K3 33 times besides phase 7's counts (the
     backward recomputes K3 and K4's functions in plain torch), moving the
     LoRA and leaving the frozen weights untouched; then GN_IMPL alone at
     pallas (K4 at xla): the same gate, then 1 step launching exactly K3 49
     times (its 33 and the GroupNorm+SiLU of K4's 16 sites) besides phase
     7's counts;
 11. fp32: with TF32 off, each fp32 instance against its plain version in
     fp32: flash_fwd_f32 (csrc/flash_f32.cu, 3xTF32 on the tensor cores) at
     every sampling shape and, with the log-sum-exp, every train shape (max
     abs err within 1e-4 and mean within 1e-5 of the output's max abs, the
     LSE within 1e-5), one more row where attention with TF32 allowed must
     miss that gate; flash_bwd_f32_dkv/_dq at the train shapes (each
     gradient relative to its max abs); their split pre-pass
     flash_f32_split at the main path's shapes (bit-exact against
     f32_split_plain); gn_silu_conv3x3_f32 (3xTF32 on the tensor cores) at
     the fused request's conv shapes and its weight pre-pass
     gn_conv_f32_split (bit-exact against weight_split_plain); qdense_f32
     and flash_int8_f32 (the same codes: 1 fp32 ulp + 1e-3 relative) at the
     turbo shapes; each timed beside its plain version, its bound (fp32
     attention and K4 fp32: 3 × operations / the TF32 peak, "bound_basis":
     "3xTF32"; the splits: bytes; K7/K8 fp32: int8) and a yardstick the port
     never calls (SDPA on fp32 tensors, cuDNN's fp32 conv, torch._int_mm and
     fp32 F.linear); then fused_group_norm (K3) on fp32 inputs at the fused
     fp32 request's GroupNorm shapes, K3's bf16 gate in fp32 units (1 fp32
     ulp + 1e-3 relative + 1e-5 of the max abs), timed beside its plain
     version, fp32 F.group_norm (+ F.silu) and the bound.
     Then StableDiffusionPipeline.from_random() with no dtype (fp32 weights
     and compute) at SD2.1-base widths with a rank-4 LoRA: its kernel path
     against its plain-attention path on 2×128² (image diff max 1e-3, mean
     1e-4), its fused-GroupNorm routes on the same input (K4's and K3's
     fp32 instances) and, after the requests, its w8a8 + flash_int8 routes
     against their plain versions (qdense_f32, flash_int8_f32; 1e-1, 1e-2);
     2 requests at batch 8, 512², 10 DDPM steps, CFG 5.0, each launching
     flash_fwd_f32 and flash_f32_split exactly 321 times each and no bf16
     kernel; then 2 fused fp32 requests (GN_IMPL and GN_CONV_IMPL at pallas,
     as phase 9 sets them) on the same pipeline, each launching exactly
     gn_silu_conv3x3_f32 and gn_conv_f32_split 160, fused_group_norm 131 and
     the attention's 321 + 321 times, its images within 1e-3 / 1e-4 of the
     default request's at the same seed, its s/request beside the default
     fp32 request's; and the train op point with fp32 frozen weights and policy:
     one loss and LoRA gradient at 2(+2)×128² against the plain-attention
     path (loss within 1e-4 relative, cosine >= 0.9999) launching
     flash_fwd_f32 34, each fp32 backward pass 33 and flash_f32_split 67
     times;
 12. checkpoints and prompts: a synthetic SD2.1-base diffusers directory
     under build/ (from_random's bf16 weights at SD2.1-base widths written
     as fp32 safetensors by the port's writer under diffusers' keys, SD2.1's
     config.json values, a byte-level CLIP tokenizer with "!" padding),
     loaded by StableDiffusionPipeline.from_pretrained (configs, every
     parameter bit-equal to the source, a tokenizer); then, at batch 8,
     512², CFG 5.0 with a rank-4 LoRA written by save_lora_safetensors and
     read by load_lora_weights: 8 prompts of the reference's grid with its
     negative prompt (30 DDPM steps, K1 960 and K2 1, images bit-equal to the
     source pipeline on the tokenized ids), num_images_per_prompt=4 on 2
     prompts (bit-equal to the repeated ids), 8 per-sample adapters with a
     (8,) scale (K1 960, K2 1; each slot within 1e-1 / 1e-2 of a
     shared-adapter call at 10 steps, the zero-scale slot of the no-LoRA
     image; also under cfg_interval (2, 8) with DeepCache-4 at 2×128²), ToMe
     at ratio 0.5 (K1 960 of which 150 at 80 × 2048², K2 1; with tome_ops
     attn,xattn also 150 at 80 × 2048 × 77; its 2×128² kernel path against
     the plain path with every tome op), decode_chunk=2
     (K2 4 at 2 × 4096² × 512, images within 1e-1 / 1e-2 of the unchunked
     ones), the latency preset at batch 1 (3 requests, K1 376, K2 1) and its
     accel report (PSNR against exact and the seed floor), and last the
     turbo preset calibrating through the tokenizer (qdense 1280) and one
     turbo request with phase 6's counts. Phase 3 holds K1 at the ToMe
     shapes and K2 at B·H 2 beside the other rows; their launches a request
     in the kernels line are the ones phase 12 counted.
 13. training driver: phase 12's directory loaded again by from_pretrained
     (phase 12 quantized its pipeline), its nets bf16 and frozen with the
     ArcFace r100 of phase 7, an fp32 rank-4 LoRA, triplet_prior, files
     under build/: generate_class_images writes 8 class images (2 requests
     at batch 4, 512², 30 DDPM steps: K1 1920, K2 2); 2 × 4 instance images
     from a seed with their ArcFace embeddings; run_identity at phase 7's
     op point (batch 4 + prior, 2 epochs of 2 steps, a checkpoint a
     epoch, 1 kept, validation after epoch 2: 4 images, 25 DPM-Solver++
     steps, K1 800, K2 1), every step launching exactly phase 7's counts,
     the LoRA moving, the frozen weights untouched, one checkpoint left and
     the validation grid written; the checkpoint read back with its
     trainable, AdamW moments and count bit-equal to what was saved; resume
     to 3 epochs running exactly one; the final LoRA file through
     load_lora_weights in a request (batch 4, 30 steps) bit-equal to
     set_lora with the trainable cast to bf16; two identities stacked, a
     2(+2)×128² gate per identity against its serial loss and gradient
     (loss within 1e-2 relative, cosine >= 0.99), then an epoch of 4
     stacked steps (2 × (2 + 2) rows) each launching exactly phase 7's
     counts, the two LoRAs differing, each with its checkpoint and export;
     gradient accumulation over 2 micro-steps, 2 without and 4 with the
     text-encoder LoRA, each launching phase 7's counts, the LoRAs
     bit-unchanged after odd micro-steps and moved after even ones, CLIP's
     weights untouched. It prints s/step (driver, stacked, accumulation)
     and peak memory beside phase 7's, and checkpoint write and read times.
 14. serving and sweep: phase 12's directory loaded again (bf16, 512², CFG
     5.0, 30 DDPM steps), three rank-4 LoRAs (two registered from files,
     one as a tree). The batch engine at batch 8: 12 requests at once over
     two adapters and none (3 padded batches), then one of them alone (its
     image equal to the one from its mixed batch, or within the per-sample
     gate 1e-1 / 1e-2; the uint8 max difference and the share of differing
     pixels printed), images differing across seeds and adapters, K1 960
     and K2 1 a batch; `multi_lora`: one batch of 8 over 3 adapters, each
     slot within the gate of its uniform batch; the rolling engine with 4
     slots: 6 requests staggered (one admitted a third of the way, two
     queued until slots free), K1 32 a tick and K2 1 a finished request at
     1 × 4096² × 512, each image within the gate of the batch engine's,
     then DPM-Solver++ at 12 steps against the batch engine at "dpm";
     `parallel_window=8` at batch 1: tolerance 0 (30 Picard iterations,
     within the gate of the sequential server) and 0.1 (its iterations and
     s/request beside the sequential request's), K1 32 an iteration; one
     HTTP /generate round trip (its PNG against the engine's image) and
     /stats on 127.0.0.1; the packed sweep of 3 variants × 21 prompts at
     batch 8 (8 batches, 1 pad slot; K1 7680, K2 8) with CR-FIQA (random
     r100 and quality head) and 6DRepNet (random RepVGG-B1g2) scoring every
     batch on the card through `on_images`: 63 PNGs and the comparison
     grid under build/, the variants' initial latents equal for each
     prompt, the scores finite; s/identity, img/s and the FIQA and pose
     rates printed. Phase 3 holds K1 at the rolling tick's L0 shapes and K2
     at 1 × 4096² × 512 beside the other rows.
 15. identity stack and FR training (`run_identity_stack`; alone:
     `perf/torch_identity_stack.py`), a path with no TPU kernel: it must
     launch none of K1-K8. The FR gate: IResNet (1, 1, 1, 1) at 112²,
     batch 8, fp32 with TF32 off, 2 steps of AdaFace, ArcFace, CosFace and
     ElasticCosFace (the same dropout masks and margins) on the card against
     the port on the CPU from the same weights: loss within 1e-4 relative,
     params within 1e-4 and BN statistics and AdaFace's EMA within 1e-5 of
     their tree's max abs. The FR bench op point: iresnet50 + AdaFace,
     batch 128, 112², 1000 classes, fp32 params, bf16 compute, 10 steps on
     one batch (s/step median after the first, train img/s, peak memory),
     one step each of ArcFace, CosFace, ElasticCosFace and the SE variant
     (finite, BN statistics moved); train_fr_run on 1000 identities × 2
     JPEGs of 112² under build/ (2 epochs of 4 steps, verification on a
     600-pair .bin in the reference's pickle layout: best_backbone.npz,
     history.json), test_fr_run reproducing the best epoch's accuracy
     exactly; s/step with the batch load and the verification seconds.
     Embedding extraction at the bench op point: 512 JPEGs of 250² in 16
     folders (bright squares of random codes in [246, 255], so that P-Net's
     cells score apart by more than rounding) + 8 black ones, the
     bright-square MTCNN,
     batch 64, r100 bf16: 512 .npy and exactly the 8 black images in
     files_without_faces.json; s/batch, img/s, detect / crop+embed / the
     rest. Gates: 8 images' detections card against CPU (fp32, TF32 off:
     the same counts, boxes and landmarks within 0.5 px, probs 1e-4); r100
     fp32 on 2 crops within 1e-3 of the max abs; extract_folder_embeddings
     (host crops) on 4 images, card against CPU at fp32 within 1e-3 (its
     cosine to the streaming path's box-sampled crops printed: the two
     paths crop differently by design), and the w8a8 r100 (quantize_iresnet,
     calibrate_embed_quant on 2 batches, a streaming run, its cosine to the
     bf16 embeddings printed) card against CPU on 2 crops at fp32 compute
     (at bf16 printed: a code rounding the other way moves the layers after
     it) within 2e-2 max / 2e-3 mean of the max abs; align_images on 16
     images (TF32 off): the card's files and report equal the CPU's, crops
     within 1 uint8 code before the JPEG encode. The random r100 has each
     block's last BN weight at 0.1 (`_damp_residuals`), as a trained one's
     residual branches are small: at 1.0 it turns one code rounding the
     other way into percents at the embedding. Backbones mbf, vit_t, vit_s at 112²:
     batch 64 bf16 finite with img/s, batch 2 fp32 (TF32 off) within 1e-4
     of the max abs of the CPU port.
 16. quality and identity evaluation (`run_quality_eval`; alone:
     `perf/torch_quality_eval.py`): 512 real, 512 generated (integer file
     names) and 256 held-out PNGs of 512² in 16 folders under build/ (smooth
     random fields tinted per folder, from a seed). `dgm.main` with dinov2
     (ViT-L/14 at 224², bf16, batch 64, seeded random weights), every metric
     (fd fd_infinity kd prdc realism vendi authpct sw ct fls, with the
     held-out set) and 4 GradCAM heatmaps: the scores JSON, the three .npz
     caches (read back bit-equal, no launch) and the grid PNG; exactly 24 K1
     launches a batch, and 24 K1 + 1 K5 pair a GradCAM probe; img/s, the
     host's PIL resize and normalise against the device's forward per
     batch, GradCAM s an image, seconds per metric. PRDC with its distances
     on the card against the CPU within 2/N, FD and KD recomputed equal. The
     other ten encoders on the generated set at batch 64 (arcface on the
     real set too): finite (N, D) at JAX's D, img/s, exactly 24 K1 a batch
     for mae, 12 for clip, no kernel for the rest; make_heatmap_fn at batch 4
     (24 K1 with the log-sum-exp, 24 K5 pairs). Then each encoder's features
     on 2 images at fp32 with TF32 off, card against a CPU copy within 1e-3
     of the max abs (the default dtype's error printed), and PyEER on the
     r100 embeddings grouped by folder (both configurations; the report
     files equal to a run on the CPU; plots where matplotlib imports). Phase
     3 holds K1 at 64 × 16 × 257², 64 × 16 × 197² and 64 × 12 × 50², with
     the log-sum-exp at 1 × 16 × 257² and 4 × 16 × 257², and K5 at the last
     two, beside the other rows.
 17. the command line (`run_cli`; alone: `perf/torch_cli.py`), in this
     process through `cli.main` so the counters see it, on phase 12's
     directory, phase 14's LoRA root and images and phases 15-16's files:
     `generate --pack_variants --eval` at DDPM 30 (3 variants × 21 prompts,
     8 batches of K1 960 and K2 1, each of the 63 PNGs equal to phase 14's
     packed sweep or within the per-sample gate 1e-1 / 1e-2, 63 FIQA
     scores and poses); `generate --preset turbo --pack_variants --eval` at
     2 prompts (calibration: K7 1280 with 680 qdense_quant; one batch of 8
     with phase 6's counts; each variant's slots within the gate of the
     same prompts unpacked on the command's own pipeline, the variants'
     images differing); `serve --multi_lora` as a child process (its
     "serving on" line and /healthz under a timeout, POST /generate twice,
     cold and warm, within the gate of phase 14's request 0, /stats, no
     kernel built); `train-idbooth`
     (1 identity of 2 images, 100 class images, triplet_prior, 1 epoch:
     100 steps with phase 7's counts each, the validation's, the exported
     LoRA loaded); `accel-report --mode deepcache=3 --mode attn=flash_int8`
     (exact K1, K2 and K8 counts, finite fields); extract-embeds (folder,
     --streaming), align-crop, train-fr and test-fr (the same accuracy),
     fiqa, pose, dgm-eval (DINOv2, 24 K1 a batch), pyeer and analyze, the
     identity and FR commands launching nothing; each command's seconds.
 18. distribution (`run_distribution`; alone: `perf/torch_distribution.py`),
     on phase 12's directory: `generate --data_parallel 1 --pack_variants`
     (3 variants × 2 prompts: one batch of 8 at DDPM 30, CFG 5.0, under
     three LoRAs the phase writes) as one NCCL rank through the normal
     entry point (torch's launcher variables, world size 1; an NCCL barrier
     after it), K1 960 and K2 1, its 6 PNGs bit-equal to the same command's
     without the flag; K1 against its plain version at the tensor-parallel
     request's per-rank shapes (model 2: levels 1, 2 and mid keep half their
     heads; level 0's 5 stay whole), and K1, K5 and K6 against theirs at a
     rank's 4 rows of the data-parallel train step; then the gloo rig, two
     ranks sharing the card (`chip_smoke.py --dist-rank`), each loading the
     directory in bf16: `sample_data_parallel` at batch 8 (4 rows a rank,
     30 DDPM steps, CFG 5.0: K1 960 and K2 1 a rank) and
     `sample_2d_parallel` at data 1 × model 2 under a per-sample rank-4
     LoRA (two adapters, 4 rows each; 10 steps: K1 320 and K2 1 a rank),
     each within 1e-1 / 1e-2 of the one-process images on the card; two
     data-parallel ID-Booth steps at phase 7's op point on the global batch
     4 + 4 (rank 0 holds the instance rows: phase 7's counts; rank 1 the
     class rows: K1 32, K2 1, K5 32 + 32, no K6), the losses within 1e-2 of
     one process's two steps on the whole batch from the same init (B
     factors off zero) and draws, the LoRA update's cosine to that run's
     >= 0.99, the LoRA bit-equal on the two ranks; and pod-rehearsal's worker at processes 2 × local_devices 1 at its tiny
     size (JAX's verdict checks). Each rank reports its launches, seconds
     and peak memory a leg; the per-rank s/request and s/step print beside
     phases 4 and 7 (two ranks sharing one card: correctness, not a
     speedup). A rank's failure or timeout fails the phase.
 19. the servers over a mesh (`run_mesh_serving`; alone:
     `perf/torch_mesh_serving.py`), on phase 12's directory: `serve
     --data_parallel 1` as one NCCL rank (torch's launcher variables), its
     PNG bit-equal to phase 17's one-process `serve` with the same flags; K1
     at a rolling rank's 2 of 4 slots (20 × 4096²) and K2 at a mesh server
     rank's decode of 4 images (4 × 4096² × 512) against their plain
     versions; then the gloo rig, two ranks sharing the card
     (`chip_smoke.py --mesh-rank`): `SamplerServer(mesh=)` at batch 8 (4
     rows a rank, DDPM 30, 512²), 8 requests under one adapter twice (the
     same images) and 8 under `multi_lora` over two adapters registered
     after the start, K1 960 and K2 1 a rank a batch; `RollingServer(mesh=)`
     at 4 slots, 5 requests staggered, K1 32 a rank a tick and K2 1 a
     finished slot on its rank; `sample_parallel(mesh=)` at batch 1, window
     8, tolerance 0 (4 positions a rank: 30 iterations, K1 960 and K2 1 a
     rank); each image within 1e-1 / 1e-2 of rank 0's one-process result;
     MoCo over the data axis (iresnet50 at 112², 64 rows a rank, the
     BatchNorm over both ranks' rows, key width 512, queue 65536, 5 SGD
     steps, fp32 with TF32 off): losses, queue and key encoder within 1e-4
     relative of one process on the 128 rows; then `serve --data_parallel
     2` from one command under FPG_BACKEND=gloo, /healthz and one request
     within the per-sample gate of the one-process PNG.
 20. the data layer and the parity runbook (`run_data_parity`; alone:
     `perf/torch_data_parity.py`), on phase 12's directory and phase 15's
     files: the native loader built with g++ and libjpeg (its seconds; a
     missing g++ or jpeglib.h is named on its own line and leaves out only
     the native legs; a failed build with both there fails); an
     insightface-layout .rec of 1000 identities × 4 JPEGs of 112² with a meta
     record, `MXFaceDataset` native against PIL on its first 4 batches of
     128 (labels equal, images within 1.5/255, host img/s of each), then
     `train_fr_run` on it at phase 15's op point (iresnet50 + AdaFace, batch
     128, bf16, 2 epochs × 4 steps, the 600-pair .bin) and `test_fr_run`
     reproducing the best accuracy, its s/step with the batch load beside
     phase 15's JPEG-folder driver; RGBN: phase 15's FR gate at
     in_channels=4 (AdaFace), iresnet50 on 4 channels at batch 128 for 10
     steps on `VISNIRDataset` batches (a NIR file for half the images:
     s/step with the load, img/s, peak memory), the step alone on one
     batch on the card as phase 15 times it, beside phase 15's 3-channel
     s/step, `load_bin_4channel` on the 600-pair VIS
     .bin and its grayscale NIR twin, `verification.test` with a 4-channel
     IResNet (1, 1, 1, 1) at fp32 on the card (all pairs) and the same
     accuracy card against CPU on the first 32 pairs; the conditional
     layouts there and back on 200 of its files, byte-equal; phase 15's 520-JPEG tree through
     `extract_embeddings_streaming` with the native decode (every batch
     through it) and with PIL, where the loader builds: the same files
     without faces, cosine >= 0.99, img/s of each; these legs launch no TPU
     kernel. `cli parity-all` (fp32, TF32 off) on sd/ (phase 12's
     directory), arcface.pth (phase 15's damped r100 in insightface keys)
     and mtcnn/ (the bright-square cascade as facenet-pytorch .pt files) at
     `--steps 5 --report_steps 10 --resolution 512`: its parity leg, `cli
     parity --full_chain` (the port against the torch mirrors: text, ε̂ per
     step and decode within 5e-4, the full chain's latents and image within
     5e-3, flash_fwd_f32 exactly 320 at head dim 64 and 2 at 512,
     flash_f32_split 322); its default gates relative to the seed floor
     (each preset's PSNR 3 dB above the floor's, its ArcFace cosine
     distance to the exact render at most half the floor's; the floor's
     cosine printed): verdict pass, nothing skipped, the accel-report's
     K1 1480, K2 5 and K7 2320 (exact and seed floor 10 full passes each,
     latency and turbo at phases 12's and 6's counts, turbo's calibration 8
     full passes and a decode), seconds a leg. Last, `core.flops`: one UNet
     call at batch 2 × 512² and one call each of K1, K2, K4 and K7 count the
     same FLOPs on the kernel route as on the plain route (K1 4·B·H·Sq·Skv·D),
     and the txt2img request's TFLOP with its rate at phase 4's s/request
     against the 989 TFLOP/s bf16 peak.
Phases 3-7 run the default configuration (GN_IMPL and GN_CONV_IMPL at xla)
whatever the environment says. The line before the last is a JSON object
with one entry per kernel; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

MAX_ERR, MEAN_ERR, LSE_ERR = 2e-2, 2e-3, 1e-3
# numbers one phase measures and a later phase prints beside its own
READINGS: dict = {}
# K7 and K8 reproduce their plain versions' codes and roundings: each output
# within 1 bf16 ulp + INT8_REL_ERR of it, and K8's mean abs err within
# INT8_MEAN_ERR
INT8_REL_ERR, INT8_MEAN_ERR = 1e-3, 1e-4
# (name, B, H, Sq, Skv, D, launches per request) at the txt2img op point:
# batch 8 under CFG is 16 UNet rows; 30 steps; the VAE decodes 8 images.
SHAPES = [
    ("self L0", 16, 5, 4096, 4096, 64, 150),
    ("self L1", 16, 10, 1024, 1024, 64, 150),
    ("self L2", 16, 20, 256, 256, 64, 150),
    ("self mid", 16, 20, 64, 64, 64, 30),
    ("cross L0", 16, 5, 4096, 77, 64, 150),
    ("cross L1", 16, 10, 1024, 77, 64, 150),
    ("cross L2", 16, 20, 256, 77, 64, 150),
    ("cross mid", 16, 20, 64, 77, 64, 30),
    ("vae mid", 8, 1, 4096, 4096, 512, 1),
]
# phase 12's new shapes, per request: ToMe at ratio 0.5 merges L0's 4096
# tokens to 2048 (5 self-attentions × 30 steps; the cross-attention too under
# tome_ops "xattn"), and decode_chunk=2 decodes 8 images 2 at a time
CKPT_SHAPES = [
    ("tome self L0", 16, 5, 2048, 2048, 64, 150),
    ("tome cross L0 (xattn)", 16, 5, 2048, 77, 64, 150),
    ("vae mid, decode_chunk 2", 2, 1, 4096, 4096, 512, 4),
]
# phase 14's new shapes: the rolling engine's tick at 4 slots (8 UNet rows:
# L0's 5 self- and 5 cross-attentions a tick; the other levels' shapes at 8
# rows as well), and its batch-1 decode of a finished slot
SERVE_TICK_SHAPES = [
    ("rolling self L0", 8, 5, 4096, 4096, 64, 5),
    ("rolling cross L0", 8, 5, 4096, 77, 64, 5),
]
SERVE_DECODE_SHAPES = [("vae mid, rolling decode", 1, 1, 4096, 4096, 512, 1)]
# (name, B, H, Sq, Skv, D, launches per train step) at the train op point: 8
# UNet rows (4 instance + 4 class images); per step 5 transformers at each
# of the three outer levels and 1 in the mid block, each with one self- and
# one cross-attention; the VAE encodes 8 images and decodes 4 (x̂0).
TRAIN_SHAPES = [
    ("self L0", 8, 5, 4096, 4096, 64, 5),
    ("self L1", 8, 10, 1024, 1024, 64, 5),
    ("self L2", 8, 20, 256, 256, 64, 5),
    ("self mid", 8, 20, 64, 64, 64, 1),
    ("cross L0", 8, 5, 4096, 77, 64, 5),
    ("cross L1", 8, 10, 1024, 77, 64, 5),
    ("cross L2", 8, 20, 256, 77, 64, 5),
    ("cross mid", 8, 20, 64, 77, 64, 1),
    ("vae encode mid", 8, 1, 4096, 4096, 512, 1),  # forward only (no_grad)
    ("vae decode mid", 4, 1, 4096, 4096, 512, 1),
]
# (name, M, K, N) of K7 at the turbo op point: batch 8 under CFG is 16 UNet
# rows, 8 on the cond-only steps outside the guidance interval
QDENSE_SHAPES = [
    ("fused qkv L0", 16 * 4096, 320, 960),
    ("ff_in L0", 16 * 4096, 320, 2560),
    ("ff_out L2", 16 * 256, 5120, 1280),
    ("cross k/v", 16 * 77, 1024, 320),
    ("ff_in L0 cond-only", 8 * 4096, 320, 2560),
]
# (name, B, H, Sq, Skv, D) of the UNet's attention on the CFG batch
INT8_SHAPES = [s[:6] for s in SHAPES if s[5] == 64]
# K8 past one 4096-key block: the self-attention of a 640² request (80²
# latent tokens), at a batch of 2 (the plain version's fp32 scores ~3 GB)
INT8_LONG = ("self 640², 2 key blocks", 2, 5, 6400, 6400, 64)
LAST_TILE_MAX = "self L0, max in the last tile"
# dense bf16 tensor-core FLOP/s, int8 tensor-core OP/s, memory bytes/s, fp32
# FLOP/s outside the tensor cores and dense TF32 tensor-core FLOP/s, from
# NVIDIA's data sheets
PEAKS = {"H100 PCIe": (756e12, 1513e12, 2.0e12, 51e12, 378e12),
         "H100 NVL": (835e12, 1671e12, 3.9e12, 60e12, 417.5e12),
         "H100": (989e12, 1979e12, 3.35e12, 67e12, 495e12)}
# K7's wide instance runs the qdense_quant pass first: per full UNet pass
# the GEGLU outputs at 640 and 1280 channels (K > 1280), every cross k/v
# projection and the mid block's ten calls (fewer than 2048 rows): 50 of
# 160; per DeepCache partial pass (level 0 only) its 10 k/v projections.
# 8 full passes in calibration; 4 full and 8 partial a request. Each
# flash_int8 call launches its amax and codes passes before K8.
TURBO_CALIB_LAUNCHES = {"qdense": 1280, "qdense_quant": 400}
TURBO_LAUNCHES = {"auto": {"qdense": 1040, "qdense_quant": 280, "flash_fwd_d64": 208, "flash_fwd_wide": 1},
                  "flash_int8": {"qdense": 1040, "qdense_quant": 280, "flash_int8": 208, "flash_int8_amax": 208,
                                 "flash_int8_codes": 208, "flash_fwd_wide": 1}}
STEP_LAUNCHES = {"flash_fwd_d64": 32, "flash_fwd_wide": 2, "flash_bwd_d64_dkv": 32, "flash_bwd_d64_dq": 32,
                 "flash_bwd_wide_dkv": 1, "flash_bwd_wide_dq": 1}
REPLACES = {
    "flash_fwd_d64": "faceposegenerator_tpu/ops/flash_attention.py:258",
    "flash_fwd_wide": "faceposegenerator_tpu/ops/flash_attention.py:104",
    "flash_bwd_d64_dkv": "faceposegenerator_tpu/ops/flash_attention.py:711",
    "flash_bwd_d64_dq": "faceposegenerator_tpu/ops/flash_attention.py:777",
    "flash_bwd_wide_dkv": "faceposegenerator_tpu/ops/flash_attention.py:542",
    "flash_bwd_wide_dq": "faceposegenerator_tpu/ops/flash_attention.py:585",
    "flash_int8": "faceposegenerator_tpu/ops/flash_attention.py:1108",
    "qdense": "faceposegenerator_tpu/ops/quant_pallas.py:47",
    "fused_group_norm": "faceposegenerator_tpu/ops/fused_gn.py:76",
    "gn_silu_conv3x3": "faceposegenerator_tpu/ops/fused_gn_conv.py:92",
    # the fp32 instances (JAX's kernels take fp32 operands as well as bf16)
    "flash_fwd_f32": "faceposegenerator_tpu/ops/flash_attention.py:258",
    "flash_bwd_f32_dkv": "faceposegenerator_tpu/ops/flash_attention.py:711",
    "flash_bwd_f32_dq": "faceposegenerator_tpu/ops/flash_attention.py:777",
    "flash_int8_f32": "faceposegenerator_tpu/ops/flash_attention.py:1108",
    "qdense_f32": "faceposegenerator_tpu/ops/quant_pallas.py:47",
    "gn_silu_conv3x3_f32": "faceposegenerator_tpu/ops/fused_gn_conv.py:92",
    # the weight pre-pass of K4's fp32 instance (its tf32 hi/lo planes)
    "gn_conv_f32_split": "faceposegenerator_tpu/ops/fused_gn_conv.py:92",
    # the fp32 attention's tf32 hi/lo pre-pass, part of the fp32 instance of K1/K2 and K5/K6
    "flash_f32_split": "faceposegenerator_tpu/ops/flash_attention.py:258",
    # K8's quantize of q, k and v (XLA ops in front of the Pallas kernel in JAX)
    "flash_int8_amax": "faceposegenerator_tpu/ops/flash_attention.py:1108",
    "flash_int8_codes": "faceposegenerator_tpu/ops/flash_attention.py:1108",
    # K7's quantize pass at K > 1280 (the TPU kernel quantizes in VMEM)
    "qdense_quant": "faceposegenerator_tpu/ops/quant_pallas.py:47",
}
# K3 and K4 round where their plain versions round. K3 sums its statistics
# in another order, which moves an output near 0 by ~1e-6 of the largest:
# each K3 output within 1 ulp + GN_REL_ERR relative + GN_MAX_FLOOR of the
# output's max abs of the plain one; each K4 output within 1 bf16 ulp +
# CONV_MAX_ERR of the output's max abs
GN_REL_ERR, GN_MAX_FLOOR, CONV_MAX_ERR = 1e-3, 1e-5, 1e-3
# (name, N, H, W, C, eps, act, launches per request) of K3 in the fused
# configuration (GN_IMPL and GN_CONV_IMPL at pallas) of the txt2img op point:
# per UNet pass the 5 + 5 transformer norms at 64² and 32², down L2's first
# norm1 (its conv goes to 1280 channels, which K4 refuses) and conv_norm_out;
# the VAE decode's resblocks at 64² (mid 4, first up block 6) and its mid
# attention's norm (S·C caps K3 at 64²·640: 128² and up stay plain)
GN_SHAPES = [
    ("unet xf L0", 16, 64, 64, 320, 1e-6, None, 150),
    ("unet xf L1", 16, 32, 32, 640, 1e-6, None, 150),
    ("unet down L2 norm1", 16, 16, 16, 640, 1e-5, "silu", 30),
    ("unet conv_norm_out", 16, 64, 64, 320, 1e-5, "silu", 30),
    ("vae decode resblocks", 8, 64, 64, 512, 1e-6, "silu", 10),
    ("vae decode attention", 8, 64, 64, 512, 1e-6, None, 1),
]
# K3's fp32 instance on the fused fp32 request: 10 steps, not 30 (131 = 10 · 12 + 11)
GN_F32_SHAPES = [(label, *rest, per // 3 if label.startswith("unet") else per)
                 for label, *rest, per in GN_SHAPES]
# K4's GroupNorm+SiLU sites (eps 1e-5), which go to K3 when GN_IMPL alone is
# pallas (GN_ALONE_LAUNCHES; the 210 at 64²·320 are "unet conv_norm_out"'s
# shape): per request, L1's first resblock norm2 at 32²·320 (30), L1's
# 640-wide norms (180) and up L0's 640-wide norm1 at 64² (60)
GN_ALONE_SHAPES = [
    ("gn alone L1 norm 32²·320", 16, 32, 32, 320, 1e-5, "silu", 30),
    ("gn alone L1 norm 32²·640", 16, 32, 32, 640, 1e-5, "silu", 180),
    ("gn alone up L0 norm1 64²·640", 16, 64, 64, 640, 1e-5, "silu", 60),
]
# per train step: one UNet pass on 8 rows, the VAE encoding 8 images (its
# last down block 4, mid 4 + 1, norm_out 1) and decoding 4 (11)
GN_TRAIN_SHAPES = [
    ("unet xf L0", 8, 64, 64, 320, 1e-6, None, 5),
    ("unet xf L1", 8, 32, 32, 640, 1e-6, None, 5),
    ("unet down L2 norm1", 8, 16, 16, 640, 1e-5, "silu", 1),
    ("unet conv_norm_out", 8, 64, 64, 320, 1e-5, "silu", 1),
    ("vae encode resblocks, norm_out", 8, 64, 64, 512, 1e-6, "silu", 9),
    ("vae encode attention", 8, 64, 64, 512, 1e-6, None, 1),
    ("vae decode resblocks", 4, 64, 64, 512, 1e-6, "silu", 10),
    ("vae decode attention", 4, 64, 64, 512, 1e-6, None, 1),
]
# (name, N, H, W, Cin, Cout, launches per request) of K4: per UNet pass down
# L0's 4, down L1's 1 + 3, up L1's 3 norm2/conv2, up L0's 2 at 640 → 320
# and 3 norm2/conv2 (up L0's first resblock takes 960 channels; the
# 1280-wide levels fail `supported`)
CONV_SHAPES = [
    ("L0 320→320", 16, 64, 64, 320, 320, 210),
    ("L1 320→640", 16, 32, 32, 320, 640, 30),
    ("L1 640→640", 16, 32, 32, 640, 640, 180),
    ("L0 up 640→320", 16, 64, 64, 640, 320, 60),
]
CONV_TRAIN_SHAPES = [(label, 8, h, w, cin, cout, per // 30) for label, _, h, w, cin, cout, per in CONV_SHAPES]
# K4's fp32 instance on the fused fp32 request: 10 steps, not 30
CONV_F32_SHAPES = [(label, n, h, w, cin, cout, per // 3) for label, n, h, w, cin, cout, per in CONV_SHAPES]
BORDER = "L0 320→320, beta + 3"
# The fp32 instances (attention in 3xTF32 on the tensor cores, the rest in
# fp32 FFMA or exact int8) are held to their plain versions in fp32 with
# TF32 off: max abs err within F32_MAX_ERR and mean
# abs err within F32_MEAN_ERR of the output's max abs (each gradient's, for
# the backward), the log-sum-exp within F32_LSE_ERR; TF32 attention must miss
# that gate. qdense_f32 and flash_int8_f32 keep K7's and K8's gates with the
# fp32 ulp. The fp32 pipeline's kernel path within F32_IMG_MAX / F32_IMG_MEAN
# of its plain-attention path; the fp32 train check's loss within 1e-4
# relative and LoRA gradient cosine >= 0.9999.
F32_MAX_ERR, F32_MEAN_ERR, F32_LSE_ERR = 1e-4, 1e-5, 1e-5
F32_IMG_MAX, F32_IMG_MEAN = 1e-3, 1e-4
# per fp32 request (10 steps of 32 UNet attentions, the VAE's one) and per
# fp32 loss and gradient at the train op point (as STEP_LAUNCHES); every
# fp32 attention forward and backward call splits its operands in one
# flash_f32_split launch
F32_REQUEST_LAUNCHES = {"flash_fwd_f32": 321, "flash_f32_split": 321}
# per fused fp32 request: K4's fp32 instance 16 times a UNet pass (FUSED_LAUNCHES'
# 480 over 30 steps) and its weight pre-pass as often; K3 12 times a UNet
# pass and 11 in the VAE decode (FUSED_LAUNCHES' 371 = 30 · 12 + 11)
F32_FUSED_LAUNCHES = dict(F32_REQUEST_LAUNCHES, gn_silu_conv3x3_f32=160, gn_conv_f32_split=160, fused_group_norm=131)
F32_TRAIN_LAUNCHES = {"flash_fwd_f32": 34, "flash_bwd_f32_dkv": 33, "flash_bwd_f32_dq": 33, "flash_f32_split": 67}
# (name, B, H, S, D, jobs) of flash_f32_split at the fp32 main-path shapes:
# the forward's q, k (natural) and v (transposed); the backward's q, k, v,
# dO (natural), q, dO and k (transposed)
F32_FWD_SPLIT = ((False, "q"), (False, "k"), (True, "v"))
F32_BWD_SPLIT = ((False, "q"), (False, "k"), (False, "v"), (False, "do"), (True, "q"), (True, "do"), (True, "k"))
SPLIT_SHAPES = [
    ("fwd self L0", 16, 5, 4096, 64, F32_FWD_SPLIT),
    ("fwd vae mid", 8, 1, 4096, 512, F32_FWD_SPLIT),
    ("bwd self L0", 8, 5, 4096, 64, F32_BWD_SPLIT),
    ("bwd vae decode mid", 4, 1, 4096, 512, F32_BWD_SPLIT),
]
FUSED_LAUNCHES = {"gn_silu_conv3x3": 480, "fused_group_norm": 371, "flash_fwd_d64": 960, "flash_fwd_wide": 1}
# GN_IMPL alone at pallas: K4's 480 GroupNorm+SiLU sites (every one a shape
# K3 takes: 64²·320, 32²·320, 32²·640, 64²·640) go to K3 with the 371
GN_ALONE_LAUNCHES = {"fused_group_norm": 371 + 480, "flash_fwd_d64": 960, "flash_fwd_wide": 1}
FUSED_STEP_LAUNCHES = dict(STEP_LAUNCHES, gn_silu_conv3x3=16, fused_group_norm=33)
# GN_IMPL alone at pallas in the train step: K3 takes its 33 norms and the
# GroupNorm+SiLU of K4's 16 sites a step (CONV_TRAIN_SHAPES: 64²·320 7,
# 32²·320 1, 32²·640 6, 64²·640 2, every one a shape K3 takes), forward only
GN_ALONE_STEP_LAUNCHES = dict(STEP_LAUNCHES, fused_group_norm=33 + 16)
# the txt2img request's exact launches, and the latency preset's at batch 1:
# DPM++ 20 steps, DeepCache-3, guidance (3, 13) make 8 full UNet passes (32
# attentions) and 12 partial ones (10: level 0's five transformers)
REQUEST_LAUNCHES = {"flash_fwd_d64": 960, "flash_fwd_wide": 1}
LATENCY_LAUNCHES = {"flash_fwd_d64": 8 * 32 + 12 * 10, "flash_fwd_wide": 1}
# the reference's negative prompt and prompt grid (inference_ID-Booth.py:33-45,138)
NEGATIVE_PROMPT = ("cartoon, cgi, render, illustration, painting, drawing, black and white, "
                   "bad body proportions, landscape")
GRID = [("", "woman", "forest", False), ("young", "man", "city street", True), ("old", "woman", "", True),
        ("middle-aged", "man", "beach", False), ("", "man", "office", True), ("young", "woman", "laboratory", False),
        ("old", "man", "night club", False), ("middle-aged", "woman", "hospital", True)]
PROMPTS = [("face side-portrait photo of " if side else "face portrait photo of ")
           + " ".join(x for x in (age, gender, "sks person") if x) + (f", {bg} background" if bg else "")
           for age, gender, bg, side in GRID]
# SD2.1-base's diffusers config.json values (stabilityai/stable-diffusion-2-1-base)
SD21_CONFIGS = {
    "unet": {"_class_name": "UNet2DConditionModel", "act_fn": "silu", "attention_head_dim": [5, 10, 20, 20],
             "block_out_channels": [320, 640, 1280, 1280], "center_input_sample": False,
             "cross_attention_dim": 1024, "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "downsample_padding": 1, "dual_cross_attention": False, "flip_sin_to_cos": True, "freq_shift": 0,
             "in_channels": 4, "layers_per_block": 2, "mid_block_scale_factor": 1, "norm_eps": 1e-05,
             "norm_num_groups": 32, "out_channels": 4, "sample_size": 64,
             "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3, "use_linear_projection": True},
    "vae": {"_class_name": "AutoencoderKL", "act_fn": "silu", "block_out_channels": [128, 256, 512, 512],
            "down_block_types": ["DownEncoderBlock2D"] * 4, "in_channels": 3, "latent_channels": 4,
            "layers_per_block": 2, "norm_num_groups": 32, "out_channels": 3, "sample_size": 512,
            "scaling_factor": 0.18215, "up_block_types": ["UpDecoderBlock2D"] * 4},
    "text_encoder": {"architectures": ["CLIPTextModel"], "hidden_act": "gelu", "hidden_size": 1024,
                     "intermediate_size": 4096, "max_position_embeddings": 77, "num_attention_heads": 16,
                     "num_hidden_layers": 23, "projection_dim": 512, "vocab_size": 49408},
}


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no peak rates known for {name!r}")


def time_ms(fn, torch, target_ms: float = 200.0) -> float:
    """Mean device time of fn() over repeated launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(3, min(100, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _inputs(torch, g, b, h, sq, skv, d, dtype=None):
    """Unit-normal q, k, v in `dtype` (bf16 by default); self-attention as
    strided views of one fused q/k/v projection, as the UNet makes them."""
    dtype = dtype or torch.bfloat16
    if sq == skv:
        qkv = torch.randn(b, sq, 3, h, d, generator=g, device="cuda").to(dtype)
        return qkv.unbind(2)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(b, skv, h, d, generator=g, device="cuda").to(dtype) for _ in "kv")
    return q, k, v


def _bound(card, flops, nbytes, int8=False, fp32=False, tf32x3=False):
    """(ms, "operations" or "bytes"): the larger of flops over the peak of
    their type and nbytes over the memory rate. fp32 work on the tensor
    cores (`tf32x3`) counts three TF32 products per fp32 one: the least the
    card needs for fp32 accuracy (the 3xTF32 bound)."""
    peak_bf16, peak_int8, peak_bw, peak_fp32, peak_tf32 = peaks(card)
    if tf32x3:
        t_ops = 3.0 * flops / peak_tf32
    else:
        t_ops = flops / (peak_int8 if int8 else peak_fp32 if fp32 else peak_bf16)
    t_bytes = nbytes / peak_bw
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _err(out, ref):
    e = (out.float() - ref.float()).abs()
    return e.max().item(), e.mean().item()


def _ulp_err(out, ref, rel=INT8_REL_ERR, of_max=0.0):
    """(max abs err, mean abs err, how many outputs differ from ref by more
    than 1 ulp of out's dtype (bf16, or fp32) + rel·|ref| + of_max·max |ref|)."""
    import torch

    ref = ref.float()
    err = (out.float() - ref).abs()
    ulp = _bf16_ulp(ref, 24 if out.dtype == torch.float32 else 8)
    over = int((err > ulp + rel * ref.abs() + of_max * ref.abs().max()).sum())
    return err.max().item(), err.mean().item(), over


def check_kernels(torch, fa, card, shapes=SHAPES, with_lse=False, per="request"):
    """The forward kernels at `shapes`, with the log-sum-exp if asked."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, b, h, sq, skv, d, per_run in shapes:
        kernel = fa.flash_fwd_d64 if d == 64 else fa.flash_fwd_wide
        name = "flash_fwd_d64" if d == 64 else "flash_fwd_wide"
        q, k, v = _inputs(torch, g, b, h, sq, skv, d)
        scale = d**-0.5
        out = kernel(q, k, v, scale, with_lse=with_lse)
        torch.cuda.synchronize()
        lse_err = None
        if with_lse:
            out, lse = out
            ref, ref_lse = fa.attention_plain_lse(q.float(), k.float(), v.float(), scale)
            lse_err = (lse - ref_lse).abs().max().item()
        else:
            ref = fa.attention_plain(q.float(), k.float(), v.float(), scale)
        max_err, mean_err = _err(out, ref)
        del ref
        plain = fa.attention_plain_lse if with_lse else fa.attention_plain
        ms = time_ms(lambda: kernel(q, k, v, scale, with_lse=with_lse), torch)
        plain_ms = time_ms(lambda: plain(q, k, v, scale), torch)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), torch)
        # q, k, v read once, o (and lse) written once
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv) + (4.0 * b * h * sq if with_lse else 0.0)
        flops = 4.0 * b * h * sq * skv * d
        bound_ms, bound_by = _bound(card, flops, nbytes)
        row = dict(kernel=name, shape=label, lse=with_lse, B=b, H=h, Sq=sq, Skv=skv, D=d, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms * 1e-9,
                   max_abs_err=max_err, mean_abs_err=mean_err, lse_max_err=lse_err, **{f"launches_per_{per}": per_run})
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if not (max_err <= MAX_ERR and mean_err <= MEAN_ERR) or (with_lse and not lse_err <= LSE_ERR):
            fail(f"{name} at {label}: max abs err {max_err} mean {mean_err} lse err {lse_err}")
        del q, k, v, out
        torch.cuda.empty_cache()
    return rows


def check_layer_norm(torch):
    """`ops.norms.layer_norm` on bf16 x and bf16 gamma and beta at the
    UNet's widths: the output bf16, at most 0.01% of its elements off the
    fp32 LayerNorm rounded once to bf16 (JAX's), and a gradient through it
    (the eval ViTs' GradCAM takes one)."""
    from faceposegenerator_tpu_torch.ops.norms import layer_norm

    g = torch.Generator(device="cuda").manual_seed(4)
    for rows, width in ((16 * 4096, 320), (16 * 256, 1280)):
        x = (torch.randn(rows, width, generator=g, device="cuda") * 3 + 0.5).bfloat16().requires_grad_(True)
        gamma = (1 + 0.2 * torch.randn(width, generator=g, device="cuda")).bfloat16()
        beta = (0.2 * torch.randn(width, generator=g, device="cuda")).bfloat16()
        out = layer_norm(x, gamma, beta)
        ref = torch.nn.functional.layer_norm(x.detach().float(), (width,), gamma.float(), beta.float()).bfloat16()
        differ = float((out != ref).float().mean())
        (dx,) = torch.autograd.grad(out.float().square().sum(), x)
        ms = time_ms(lambda: layer_norm(x, gamma, beta), torch)
        affine_ms = time_ms(lambda: torch.nn.functional.layer_norm(x, (width,), gamma, beta), torch)
        print(f"layer_norm bf16, {rows} × {width}: {out.dtype}, {differ:.4%} of the elements off the fp32 LayerNorm "
              f"rounded once; gradient {dx.dtype}, finite {bool(dx.isfinite().all())}; {ms:.4f} ms a call (the op "
              f"with its affine in bf16: {affine_ms:.4f} ms)", flush=True)
        if out.dtype != torch.bfloat16 or differ > 1e-4 or not dx.isfinite().all():
            fail("layer_norm's mixed-dtype path on the card")


def check_backward(torch, fa, card, shapes, per="step"):
    """K5/K6 at the train shapes: the forward's own o and lse, a unit-normal
    dO, each gradient against attention_bwd_plain in fp32 on the same
    inputs; each pass timed alone, the pair beside the plain backward and
    SDPA's backward through autograd on the same tensors."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, b, h, sq, skv, d, per_step in shapes:
        kind = "d64" if d == 64 else "wide"
        fwd, bwd = (fa.flash_fwd_d64, fa.flash_bwd_d64) if d == 64 else (fa.flash_fwd_wide, fa.flash_bwd_wide)
        q, k, v = _inputs(torch, g, b, h, sq, skv, d)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(torch.bfloat16)
        scale = d**-0.5
        o, lse = fwd(q, k, v, scale, with_lse=True)
        grads = bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        refs = fa.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
        errs = [_err(x, r) for x, r in zip(grads, refs)]
        # the gate is relative to each gradient's max abs: a key's dk and dv sum
        # over every query, so at 77 keys they reach ~4 and bf16 rounding alone
        # exceeds an absolute 2e-2
        norms = [r.abs().max().item() for r in refs]
        del refs, grads
        torch.cuda.empty_cache()
        ms = {p: time_ms(lambda p=p: bwd(q, k, v, o, lse, do, scale, passes=(p,)), torch) for p in ("dkv", "dq")}
        pair_ms = time_ms(lambda: bwd(q, k, v, o, lse, do, scale), torch)
        plain_ms = time_ms(lambda: fa.attention_bwd_plain(q, k, v, o, lse, do, scale), torch)
        torch.cuda.empty_cache()
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        dot = do.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), torch)
        del out, qt, kt, vt
        # q, o, dO, dq (Sq rows) and k, v, dk, dv (Skv rows) in bf16, lse and D in fp32
        unit = b * h * sq * skv * d
        io = 2.0 * b * h * d
        pair_bound, pair_by = _bound(card, 10.0 * unit, io * (4 * sq + 4 * skv) + 8.0 * b * h * sq)
        # each pass alone: S, dP, dV, dK (dK/dV pass) or S, dP, dQ (dQ pass)
        dkv_bound, dkv_by = _bound(card, 8.0 * unit, io * (2 * sq + 4 * skv) + 8.0 * b * h * sq)
        dq_bound, dq_by = _bound(card, 6.0 * unit, io * (3 * sq + 2 * skv) + 8.0 * b * h * sq)
        (dq_max, dq_mean), (dk_max, dk_mean), (dv_max, dv_mean) = errs
        row = dict(kernel=f"flash_bwd_{kind}", shape=label, B=b, H=h, Sq=sq, Skv=skv, D=d,
                   dkv_ms=ms["dkv"], dq_ms=ms["dq"], pair_ms=pair_ms, plain_ms=plain_ms, library_ms=library_ms,
                   pair_bound_ms=pair_bound, pair_bound_by=pair_by, dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
                   dq_bound_ms=dq_bound, dq_bound_by=dq_by, tflops=10.0 * unit / pair_ms * 1e-9,
                   dkv_tflops=8.0 * unit / ms["dkv"] * 1e-9, dq_tflops=6.0 * unit / ms["dq"] * 1e-9,
                   dq_err=[dq_max, dq_mean], dk_err=[dk_max, dk_mean], dv_err=[dv_max, dv_mean],
                   grad_max_abs=norms, **{f"launches_per_{per}": per_step})
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        for name, (mx, mean), n in zip(("dq", "dk", "dv"), errs, norms):
            if not (mx <= MAX_ERR * n and mean <= MEAN_ERR * n):
                fail(f"flash_bwd_{kind} {name} at {label}: max abs err {mx} mean {mean}, "
                     f"gradient max abs {n} (limits 2e-2 and 2e-3 of it)")
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    return rows


def _bf16_ulp(t, bits=8):
    """The spacing of bf16 numbers at |t| (8 significant bits; 24: fp32)."""
    import torch

    return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs().clamp_min(2.0**-126))[1] - bits)


def _quant_pass(torch, qd, card, x, a):
    """Where K7 takes its wide instance (K > 1280, or fewer than 2048 rows):
    qdense_quant's codes and row scales against quantize()
    (bit-exact, or fail), its time, its plain version's (quantize()) and its
    bound (x read, the codes and row scales written)."""
    m, k = x.shape
    if not qd.is_wide(m, k):
        return {}
    codes, sx = qd.quantize_rows(x, a)
    want, want_sx = qd.quantize(x, -1, a)
    exact = torch.equal(codes, want.to(torch.int8)) and (a is not None or torch.equal(sx, want_sx.reshape(m)))
    if not exact:
        fail(f"qdense_quant at M {m} K {k}: its codes or row scales differ from quantize()")
    del codes, sx, want, want_sx
    bound_ms, _ = _bound(card, 0.0, x.element_size() * m * k + m * k + 4.0 * m)
    return dict(quant_ms=time_ms(lambda: qd.quantize_rows(x, a), torch),
                quant_plain_ms=time_ms(lambda: qd.quantize(x, -1, a), torch), quant_bound_ms=bound_ms,
                quant_exact=exact)


def check_qdense(torch, card):
    """K7 in both modes at the turbo dense shapes against qdense_plain on the
    same inputs: x unit-normal bf16, a random weight quantized per channel,
    the static scale from x's amax with the calibration margin 1.1."""
    import torch.nn.functional as F

    from faceposegenerator_tpu_torch.ops import qdense as qd
    from faceposegenerator_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label, m, k, n in QDENSE_SHAPES:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device="cuda") * k**-0.5).to(torch.bfloat16)
        qw = quantize_weight(w)
        for mode in ("dynamic", "static"):
            a = float(x.float().abs().amax()) * 1.1 / 127.0 if mode == "static" else None
            out = qd.qdense_kernel(x, qw.q, qw.s, a)
            torch.cuda.synchronize()
            max_err, mean_err, over = _ulp_err(out, qd.qdense_plain(x, qw.q, qw.s, a))
            del out
            ms = time_ms(lambda: qd.qdense_kernel(x, qw.q, qw.s, a), torch)
            plain_ms = time_ms(lambda: qd.qdense_plain(x, qw.q, qw.s, a), torch)
            codes = qd.quantize(x, -1, a)[0].to(torch.int8)
            int_mm_ms = time_ms(lambda: torch._int_mm(codes, qw.q.t()), torch)
            linear_ms = time_ms(lambda: F.linear(x, w), torch)
            del codes
            # x bf16 and the int8 weight with its scales read once, y bf16 written once
            bound_ms, bound_by = _bound(card, 2.0 * m * n * k, 2.0 * m * k + n * k + 4.0 * n + 2.0 * m * n, int8=True)
            row = dict(kernel="qdense", shape=label, mode=mode, M=m, K=k, N=n, ms=ms, plain_ms=plain_ms,
                       int_mm_ms=int_mm_ms, bf16_linear_ms=linear_ms, bound_ms=bound_ms, bound_by=bound_by,
                       max_abs_err=max_err, mean_abs_err=mean_err, over_limit=over,
                       **_quant_pass(torch, qd, card, x, a))
            print("kernel " + json.dumps(row), flush=True)
            rows.append(row)
            if over:
                fail(f"qdense {mode} at {label}: {over} outputs differ from the plain version by more than "
                     f"1 bf16 ulp + {INT8_REL_ERR} relative (max abs err {max_err})")
        del x, w, qw
        torch.cuda.empty_cache()
    return rows


def _last_tile_max_inputs(torch, g, b, h, s, d):
    """q unit-normal; the last 64 keys are 2·q of the first 64 queries and
    the others 0.3·N(0, 1), so every row's maximum lies in the last 64-key
    tile, far above what came before it."""
    q = torch.randn(b, s, h, d, generator=g, device="cuda")
    k = 0.3 * torch.randn(b, s, h, d, generator=g, device="cuda")
    k[:, -64:] = 2.0 * q[:, :64]
    v = torch.randn(b, s, h, d, generator=g, device="cuda")
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def _int8_gate_refuses(torch, fa, q, k, v, scale, want):
    """The errors of exact attention and of a running-max softmax over
    64-key tiles against K8's plain version `want`; both must fail the K8
    gate, or the gate could not tell them from the kernel."""
    exact = fa.attention_plain(q.float(), k.float(), v.float(), scale).to(q.dtype)
    saved, fa._INT8_BLOCK_K = fa._INT8_BLOCK_K, 64
    try:
        running = fa.attention_int8_plain(q, k, v, scale)
    finally:
        fa._INT8_BLOCK_K = saved
    errs = {"exact": _ulp_err(exact, want), "running_max": _ulp_err(running, want)}
    for name, (mx, mean, over) in errs.items():
        if not (over or mean > INT8_MEAN_ERR):
            fail(f"the flash_int8 gate passes {name} attention at {LAST_TILE_MAX} (max abs err {mx}, mean {mean})")
    return {name: [mx, mean] for name, (mx, mean, _) in errs.items()}


def _int8_launches(torch, fa, card, q, k, v, scale):
    """K8's three launches one by one: the amax and codes passes against
    int8_codes_plain (bit-exact, or fail), each launch's time (the
    attention on ready codes: `attend_ms`) with its bound, and the plain
    amax's and codes' times."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q8, k8, vt, ws = fa.int8_codes(q, k, v, scale)
    want = fa.int8_codes_plain(q, k, v, scale)
    exact = all(torch.equal(x, y) for x, y in zip((q8, k8, vt), want[:3])) and torch.equal(ws[4:6], want[3])
    if not exact:
        fail(f"flash_int8_codes at B{b} H{h} Sq{sq} Skv{skv}: the codes or constants differ from int8_codes_plain")
    del want
    elems = b * h * d * (sq + 2 * skv)
    attend_bound, attend_by = _bound(card, 4.0 * b * h * sq * skv * d, elems + q.element_size() * b * h * d * sq,
                                     int8=True)
    return dict(
        codes_exact=exact,
        amax_ms=time_ms(lambda: fa.int8_amax(q, k, v, ws), torch),
        amax_plain_ms=time_ms(lambda: [t.abs().amax() for t in (q, k, v)], torch),
        amax_bound_ms=_bound(card, 0.0, q.element_size() * elems)[0],
        codes_ms=time_ms(lambda: fa.int8_quantize(q, k, v, ws, scale), torch),
        codes_plain_ms=time_ms(lambda: fa.int8_codes_plain(q, k, v, scale), torch),
        codes_bound_ms=_bound(card, 0.0, (q.element_size() + 1) * elems)[0],
        attend_ms=time_ms(lambda: fa.int8_attend(q8, k8, vt, ws, q.shape, q.dtype, skv), torch),
        attend_bound_ms=attend_bound, attend_bound_by=attend_by,
    )


def check_int8(torch, fa, card, shapes=INT8_SHAPES):
    """K8 at the UNet's attention shapes against attention_int8_plain and
    exact attention on the same bf16 inputs, then at the 4096-token
    self-attention with every row's maximum in the last key tile, then past
    one 4096-key block (INT8_LONG)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, b, h, sq, skv, d in [*shapes, (LAST_TILE_MAX, *shapes[0][1:]), INT8_LONG]:
        last_tile = label == LAST_TILE_MAX
        q, k, v = _last_tile_max_inputs(torch, g, b, h, sq, d) if last_tile else _inputs(torch, g, b, h, sq, skv, d)
        scale = d**-0.5
        out = fa.flash_attention_int8(q, k, v, scale)
        torch.cuda.synchronize()
        want = fa.attention_int8_plain(q, k, v, scale)
        max_err, mean_err, over = _ulp_err(out, want)
        extra = {}
        if last_tile:
            extra["refused_errs"] = _int8_gate_refuses(torch, fa, q, k, v, scale, want)
            rel = None
        else:
            # against exact attention as the JAX test holds it (q and k at
            # half the unit scale, tests/test_ops.py:391-393); at unit scale
            # over 4096 keys most p fall on the lowest codes of the 1/127
            # grid (reported)
            exact = fa.attention_plain(q.float(), k.float(), v.float(), scale)
            extra["rel_err_vs_exact_unit_scale"] = ((out.float() - exact).norm() / exact.norm()).item()
            qh, kh = q * 0.5, k * 0.5
            exact = fa.attention_plain(qh.float(), kh.float(), v.float(), scale)
            rel = ((fa.flash_attention_int8(qh, kh, v, scale).float() - exact).norm() / exact.norm()).item()
            del exact, qh, kh
        del out, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fa.flash_attention_int8(q, k, v, scale), torch)
        plain_ms = time_ms(lambda: fa.attention_int8_plain(q, k, v, scale), torch)
        k1_ms = time_ms(lambda: fa.flash_fwd_d64(q, k, v, scale), torch)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), torch)
        # QKᵀ and PV in int8; q, k, v read once in bf16, o written once
        bound_ms, bound_by = _bound(card, 4.0 * b * h * sq * skv * d, 2.0 * b * h * d * (2 * sq + 2 * skv), int8=True)
        row = dict(kernel="flash_int8", shape=label, B=b, H=h, Sq=sq, Skv=skv, D=d, ms=ms, plain_ms=plain_ms,
                   k1_ms=k1_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
                   mean_abs_err=mean_err, over_limit=over, rel_err_vs_exact=rel, **extra,
                   **_int8_launches(torch, fa, card, q, k, v, scale))
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if over or mean_err > INT8_MEAN_ERR or not (last_tile or rel <= 3e-2):
            fail(f"flash_int8 at {label}: {over} outputs beyond 1 bf16 ulp + {INT8_REL_ERR} relative of the plain "
                 f"version, max abs err {max_err}, mean {mean_err} (limit {INT8_MEAN_ERR}); rel err {rel} vs exact")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


class gn_route:
    """Within the block, GN_IMPL is `impl` and GN_CONV_IMPL `conv` (by
    default `impl` too), as the two environment variables set them at import
    (perf/r3_gnconv_bs.py:39 sets the JAX modules' attributes the same way);
    the previous values after."""

    def __init__(self, impl, conv=None):
        self.impl, self.conv = impl, conv or impl

    def __enter__(self):
        from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv

        self.saved = (fused_gn._GN_IMPL, fused_gn_conv._IMPL)
        fused_gn._GN_IMPL, fused_gn_conv._IMPL = self.impl, self.conv
        return self

    def __exit__(self, *exc):
        from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv

        fused_gn._GN_IMPL, fused_gn_conv._IMPL = self.saved


def host_us(fn, torch, n=1000):
    """The host time of one fn() in µs: time.perf_counter over n calls with
    no synchronisation (then one, outside the clock). Where the device is
    slower than the host, the launch queue fills and this is device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def _gn_launch(fg, x, gamma, beta, eps, act):
    """K3's one C call as the wrapper makes it for these inputs, to replay on
    ready buffers (the output it writes is kept alive with it); a replay
    counts no launch."""
    calls, get = [], fg._kernel
    fg._kernel = lambda: (lambda *args: calls.append(args) or get()(*args))
    try:
        y = fg.fused_group_norm(x, gamma, beta, 32, eps, act)
    finally:
        fg._kernel = get
    fn, (args,) = get(), calls
    return lambda: (fn(*args), y)


def gn_clusters(n, c, plan, itemsize):
    """How many clusters of K3's launch for `plan` (cluster, rows, stages)
    the card holds at once (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from faceposegenerator_tpu_torch.ops import _build

    fn = _build.load("fused_gn").fused_group_norm_clusters
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    active = ctypes.c_int(0)
    cluster, _, stages = plan
    if fn(n, c, cluster, stages, int(itemsize == 2), ctypes.byref(active)) != 0:
        fail(f"cudaOccupancyMaxActiveClusters failed for K3's plan {plan}")
    return active.value


def check_gn(torch, card, shapes, per, dtype=None):
    """K3 at `shapes` against fused_group_norm_plain on the same inputs in
    `dtype` (bf16 by default; x = 3·N(0, 1) + 1, γ and β unit normal, 32
    groups), within 1 ulp of the dtype + 1e-3 relative + 1e-5 of the max abs,
    timed as a call (`ms`), as its launch alone on ready buffers
    (`launch_ms`) and by the wrapper's host time (`host_us`), beside its
    plain version, F.group_norm (+ F.silu) on the channels_last NCHW view (a
    yardstick the port never calls) and the card's bound."""
    import torch.nn.functional as F

    from faceposegenerator_tpu_torch.ops import fused_gn as fg

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(6 if dtype == torch.bfloat16 else 16)
    rows = []
    for label, n, h, w, c, eps, act, per_run in shapes:
        x = (torch.randn(n, h, w, c, generator=g, device="cuda") * 3 + 1).to(dtype)
        gamma, beta = (torch.randn(c, generator=g, device="cuda").to(dtype) for _ in "gb")
        out = fg.fused_group_norm(x, gamma, beta, 32, eps, act)
        torch.cuda.synchronize()
        want = fg.fused_group_norm_plain(x, gamma, beta, 32, eps, act)
        max_err, mean_err, over = _ulp_err(out, want, GN_REL_ERR, GN_MAX_FLOOR)
        # reported, not gated: how many outputs a gate without the floor would refuse
        beyond_relative = _ulp_err(out, want, GN_REL_ERR)[2]
        del out, want
        call = lambda: fg.fused_group_norm(x, gamma, beta, 32, eps, act)
        ms = time_ms(call, torch)
        launch_ms = time_ms(_gn_launch(fg, x, gamma, beta, eps, act), torch)
        call_host_us = host_us(call, torch)
        plain_ms = time_ms(lambda: fg.fused_group_norm_plain(x, gamma, beta, 32, eps, act), torch)
        xv = x.permute(0, 3, 1, 2)
        library = (lambda: F.silu(F.group_norm(xv, 32, gamma, beta, eps))) if act else \
            (lambda: F.group_norm(xv, 32, gamma, beta, eps))
        library_ms = time_ms(library, torch)
        # x read once and y written once; per element a sum, a square and its
        # sum, the affine FMA and, with SiLU, ~4 more, in fp32
        elems = n * h * w * c
        bound_ms, bound_by = _bound(card, (5.0 + 4.0 * (act == "silu")) * elems,
                                    2.0 * x.element_size() * (elems + c), fp32=True)
        plan = fg.cluster_plan(n, h * w, c, x.element_size())
        row = dict(kernel="fused_group_norm", shape=label, dtype=str(dtype).split(".")[-1], N=n, H=h, W=w, C=c,
                   act=act, plan=plan, active_clusters=gn_clusters(n, c, plan, x.element_size()),
                   ms=ms, launch_ms=launch_ms, host_us=call_host_us, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
                   mean_abs_err=mean_err, over_limit=over, beyond_relative_gate=beyond_relative,
                   **{f"launches_per_{per}": per_run})
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if over:
            fail(f"fused_group_norm ({dtype}) at {label}: {over} outputs beyond 1 ulp + {GN_REL_ERR} relative + "
                 f"{GN_MAX_FLOOR} of the max abs of the plain version (max abs err {max_err})")
        del x
        torch.cuda.empty_cache()
    return rows


def _conv_inputs(torch, g, n, h, w, cin, cout, beta_shift=0.0):
    """bf16 x = N(0, 1) + 0.5, γ and β unit normal (β shifted), the weight
    uniform ±1/√(9·Cin) stored channels_last as the port keeps it, the bias
    uniform likewise."""
    x = (torch.randn(n, h, w, cin, generator=g, device="cuda") + 0.5).to(torch.bfloat16)
    gamma = torch.randn(cin, generator=g, device="cuda").to(torch.bfloat16)
    beta = (torch.randn(cin, generator=g, device="cuda") + beta_shift).to(torch.bfloat16)
    conv = torch.nn.Conv2d(cin, cout, 3, device="cuda", dtype=torch.bfloat16)
    bound = (9 * cin) ** -0.5
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=g)
        conv.bias.uniform_(-bound, bound, generator=g)
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    conv.requires_grad_(False)
    return x, gamma, beta, conv


def _pad_before_activation(torch, fgc, x, gamma, beta, conv):
    """The plain version with the zero padding applied to x before the
    normalisation and SiLU: every border tap reads SiLU(shift), not 0."""
    import torch.nn.functional as F

    scale, shift = fgc.group_scale_shift(x, gamma, beta, 32, 1e-5)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    a = F.silu(xp * scale[:, None, None] + shift[:, None, None]).to(x.dtype)
    cudnn = torch.backends.cudnn
    prev, cudnn.allow_tf32 = cudnn.allow_tf32, False
    try:
        y = F.conv2d(a.permute(0, 3, 1, 2).float(), conv.weight.float(), conv.bias.float())
    finally:
        cudnn.allow_tf32 = prev
    return y.permute(0, 2, 3, 1).to(x.dtype)


def check_conv(torch, card, shapes, per, border=False):
    """K4 at `shapes` against gn_silu_conv3x3_plain on the same inputs
    (_conv_inputs, 32 groups), timed beside its plain version, the default
    route's plain GroupNorm+SiLU and cuDNN bf16 conv (a yardstick) and the
    card's bound. With `border`, one more row at the first shape with β + 3,
    on which a pad-before-activation variant must fail the gate."""
    from faceposegenerator_tpu_torch.models.layers import conv2d
    from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
    from faceposegenerator_tpu_torch.ops.norms import group_norm_plain

    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    cases = [(*s[:6], 0.0, s[6]) for s in shapes] + ([(BORDER, *shapes[0][1:6], 3.0, 0)] if border else [])
    for label, n, h, w, cin, cout, beta_shift, per_run in cases:
        x, gamma, beta, conv = _conv_inputs(torch, g, n, h, w, cin, cout, beta_shift)
        out = fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32)
        torch.cuda.synchronize()
        want = fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, 32)
        max_err, mean_err, over = _ulp_err(out, want, 0.0, CONV_MAX_ERR)
        extra = {}
        if label == BORDER:
            mx, mean, refused = _ulp_err(_pad_before_activation(torch, fgc, x, gamma, beta, conv), want, 0.0,
                                        CONV_MAX_ERR)
            extra["pad_before_activation_err"] = [mx, mean, refused]
            if not refused:
                fail(f"the gn_silu_conv3x3 gate passes a pad-before-activation conv at {label} "
                     f"(max abs err {mx}, mean {mean})")
        del out, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32), torch)
        plain_ms = time_ms(lambda: fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, 32), torch)
        library_ms = time_ms(lambda: conv2d(group_norm_plain(x, gamma, beta, 32, 1e-5, "silu"), conv), torch)
        # x and y read and written once in bf16, the weight read once
        m = n * h * w
        bound_ms, bound_by = _bound(card, 2.0 * m * cout * 9 * cin,
                                    2.0 * m * (cin + cout) + 18.0 * cin * cout + 2.0 * cout)
        row = dict(kernel="gn_silu_conv3x3", shape=label, N=n, H=h, W=w, Cin=cin, Cout=cout, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=2.0 * m * cout * 9 * cin / ms * 1e-9, max_abs_err=max_err, mean_abs_err=mean_err, over_limit=over,
                   **{f"launches_per_{per}": per_run}, **extra)
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if over:
            fail(f"gn_silu_conv3x3 at {label}: {over} outputs beyond 1 bf16 ulp + {CONV_MAX_ERR} of the max abs of "
                 f"the plain version (max abs err {max_err})")
        del x, conv
        torch.cuda.empty_cache()
    return rows


def make_lora(unet, seed, torch, dtype=None):
    """A rank-4 UNet LoRA with nonzero B, in `dtype` (bf16 by default)."""
    from faceposegenerator_tpu_torch.models.unet2d import init_lora

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = init_lora(unet, rank=4, generator=g, dtype=dtype)

    def fill_b(node):
        if isinstance(node, dict):
            if "b" in node and "a" in node:
                node["b"] = (torch.randn(node["b"].shape, generator=g, device="cuda") * 0.05).to(dtype)
            else:
                for v in node.values():
                    fill_b(v)
        elif isinstance(node, list):
            for v in node:
                fill_b(v)

    fill_b(tree)
    return {"unet": tree, "text_encoder": None}


def run_pipeline(torch, fa, card_line):
    import numpy as np

    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    loras = [make_lora(pipe.nets["unet"], s, torch) for s in (10, 11)]
    pipe.set_lora(loras[0])
    torch.cuda.synchronize()
    print(f"pipeline: built at SD2.1-base widths in bf16 in {time.time() - t0:.1f} s", flush=True)

    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 49408, (8, 77), generator=g)

    # the kernel path against the plain-attention path on a small input
    small = dict(input_ids=ids[:2], num_inference_steps=2, height=128, width=128, seed=5)
    img_k = pipe(**small)
    plain = StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl="reference"), pipe.policy)
    plain.set_lora(loras[0])
    img_p = plain(**small)
    diff = np.abs(img_k - img_p)
    print(f"pipeline: kernels vs plain attention at 2×128², 2 steps, bf16: image diff max "
          f"{diff.max():.3e} mean {diff.mean():.3e} (limits 1e-1, 1e-2)", flush=True)
    if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2):
        fail("the kernel path and the plain-attention path disagree")

    fa.reset_launch_counts()
    images, secs = [], []
    for r, seed in enumerate((0, 1, 2)):
        if r == 2:
            pipe.set_lora(loras[1])
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.time()
        img = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0, height=512, width=512, seed=seed)
        secs.append(time.time() - t0)
        d64 = fa.LAUNCHES["flash_fwd_d64"] - before["flash_fwd_d64"]
        wide = fa.LAUNCHES["flash_fwd_wide"] - before["flash_fwd_wide"]
        print(f"request {r}: seed {seed}, {secs[-1]:.3f} s, {8 / secs[-1]:.3f} img/s, "
              f"launches d64 {d64} wide {wide} ({card_line})", flush=True)
        if img.shape != (8, 512, 512, 3):
            fail(f"image shape {img.shape}")
        if not (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0):
            fail("images not finite or outside [0, 1]")
        if d64 != 960 or wide != 1:
            fail(f"request {r} launched d64 {d64} and wide {wide} times, expected 960 and 1")
        images.append(img)
    launches = dict(fa.LAUNCHES)
    if float(np.abs(images[0] - images[1]).max()) < 1e-3:
        fail("images do not differ between seeds")
    if float(np.abs(images[1] - images[2]).max()) < 1e-3:
        fail("images do not change with the LoRA and seed")
    print(f"pipeline: bs8 512² 30-step DDPM CFG 5.0: {secs} s per request; steady "
          f"{min(secs[1:]):.3f} s = {8 / min(secs[1:]):.3f} img/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card_line})", flush=True)
    return launches, min(secs[1:])


def _launch_counts():
    from faceposegenerator_tpu_torch.ops import flash_attention as fa
    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv
    from faceposegenerator_tpu_torch.ops import qdense as qd

    return {**fa.LAUNCHES, **qd.LAUNCHES, **fused_gn.LAUNCHES, **fused_gn_conv.LAUNCHES}


def _reset_launch_counts():
    from faceposegenerator_tpu_torch.ops import flash_attention as fa
    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv
    from faceposegenerator_tpu_torch.ops import qdense as qd

    for module in (fa, qd, fused_gn, fused_gn_conv):
        module.reset_launch_counts()


class plain_route:
    """Within the block, qdense and the int8 attention take their plain
    versions on the card (the comparison of the kernel routes with the
    plain ones; nothing on the main path does this)."""

    def __enter__(self):
        from faceposegenerator_tpu_torch.ops import attention, quant
        from faceposegenerator_tpu_torch.ops import flash_attention as fa
        from faceposegenerator_tpu_torch.ops import qdense as qd

        self.saved = (quant.qdense_kernel, attention.flash_attention_int8)
        quant.qdense_kernel = qd.qdense_plain
        attention.flash_attention_int8 = fa.attention_int8_plain
        return self

    def __exit__(self, *exc):
        from faceposegenerator_tpu_torch.ops import attention, quant

        quant.qdense_kernel, attention.flash_attention_int8 = self.saved


def _check_images(img, b, res, label):
    import numpy as np

    if img.shape != (b, res, res, 3):
        fail(f"{label}: image shape {img.shape}")
    if not (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0):
        fail(f"{label}: images not finite or outside [0, 1]")


def run_turbo(torch, card_line):
    """The turbo preset on the card: the small-input gate, calibration, 3
    requests, then 2 requests of the flash_int8 configuration, each with
    exact launch counts. Returns the launch counts of the phase."""
    import numpy as np

    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.pipelines.presets import get_preset
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, 49408, (8, 77), generator=g)
    calib_ids = torch.randint(0, 49408, (8, 77), generator=g)
    preset = get_preset("turbo")

    # the kernel routes against the plain routes on a small input, with the
    # turbo sampler settings and static scales calibrated on that input
    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    pipe.set_lora(make_lora(pipe.nets["unet"], 12, torch))
    small = dict(input_ids=ids[:2], num_inference_steps=6, height=128, width=128, seed=5)
    kw = preset.apply(pipe, input_ids=ids[:2], height=128, width=128)
    kw = dict(kw, cfg_interval=(1, 5))
    torch.cuda.synchronize()
    print(f"turbo: built, quantized and calibrated at 2×128² in {time.time() - t0:.1f} s", flush=True)
    for impl in ("auto", "flash_int8"):
        p = StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl=impl), pipe.policy)
        p.set_scheduler("dpm")
        p.set_lora(pipe.lora)
        got = p(**small, **kw)
        with plain_route():
            p.models = SamplerModels(attn_impl="reference" if impl == "auto" else impl)
            want = p(**small, **kw)
        diff = np.abs(got - want)
        print(f"turbo: kernel routes vs plain routes ({impl}) at 2×128², 6 DPM steps, DeepCache-4, "
              f"cfg_interval (1, 5), static w8a8+vae, bf16: image diff max {diff.max():.3e} mean "
              f"{diff.mean():.3e} (limits 1e-1, 1e-2)", flush=True)
        if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2):
            fail(f"the turbo kernel routes and plain routes disagree ({impl})")
    del pipe, p
    torch.cuda.empty_cache()

    # the request as a user makes it
    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    pipe.set_lora(make_lora(pipe.nets["unet"], 12, torch))
    torch.cuda.synchronize()
    _reset_launch_counts()
    t1 = time.time()
    kw = preset.apply(pipe, input_ids=calib_ids)
    torch.cuda.synchronize()
    calib = {n: c for n, c in _launch_counts().items() if c}
    print(f"turbo: built in {t1 - t0:.1f} s; preset applied (dpm, w8a8+vae, 8 calibration steps at 8×512²) "
          f"in {time.time() - t1:.1f} s; kwargs {kw}; calibration launches {json.dumps(calib)}", flush=True)
    if any(calib.get(n) != c for n, c in TURBO_CALIB_LAUNCHES.items()):
        fail(f"calibration launched {calib}, expected {TURBO_CALIB_LAUNCHES} among them")
    torch.cuda.reset_peak_memory_stats()
    for impl, seeds in (("auto", (0, 1, 2)), ("flash_int8", (0, 3))):
        p = pipe if impl == "auto" else StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl=impl), pipe.policy)
        p.set_scheduler("dpm")
        p.set_lora(pipe.lora)
        images, secs = [], []
        for r, seed in enumerate(seeds):
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = p(input_ids=ids, num_inference_steps=preset.steps, guidance_scale=5.0, height=512, width=512,
                    seed=seed, **kw)
            secs.append(time.time() - t0)
            per = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
            print(f"turbo {impl} request {r}: seed {seed}, {secs[-1]:.3f} s, {8 / secs[-1]:.3f} img/s, "
                  f"launches {json.dumps(per)} ({card_line})", flush=True)
            _check_images(img, 8, 512, f"turbo {impl} request {r}")
            if per != TURBO_LAUNCHES[impl]:
                fail(f"turbo {impl} request {r} launched {per}, expected {TURBO_LAUNCHES[impl]}")
            images.append(img)
        if float(np.abs(images[0] - images[1]).max()) < 1e-3:
            fail(f"turbo {impl}: images do not differ between seeds")
        print(f"turbo {impl}: bs8 512² DPM++ 12 steps, DeepCache-4, cfg_interval (2, 8), static w8a8+vae: "
              f"{secs} s per request; after the first {min(secs[1:]):.3f} s = {8 / min(secs[1:]):.3f} img/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card_line})", flush=True)
    return dict(_launch_counts())


# remat_identity recomputes the VAE decode in the backward; off at the op point
REMAT_IDENTITY = False


def build_train_op_point(torch, dtype=None):
    """The ID-Booth train op point on the card (bench.py:99-190 with
    BENCH_KIND=train): SD2.1-base widths, ArcFace r100, random frozen
    weights from seeds 0-3 in `dtype` (bf16 by default; the compute policy
    takes the same dtype), batch 4 with prior preservation, triplet_prior."""
    from faceposegenerator_tpu_torch.core.precision import Policy
    from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
    from faceposegenerator_tpu_torch.training import idbooth

    dtype = dtype or torch.bfloat16
    models = idbooth.ModelBundle(arcface_cfg=iresnet.config_for("r100"))
    frozen = {
        "text_encoder": clip_text.CLIPTextModel(models.text_cfg, dtype=dtype, seed=0),
        "unet": unet2d.UNet2DCondition(models.unet_cfg, dtype=dtype, seed=1),
        "vae": vae.AutoencoderKL(models.vae_cfg, dtype=dtype, seed=2),
        "arcface": iresnet.IResNet(models.arcface_cfg, dtype=dtype, seed=3),
    }
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", train_batch_size=4, remat_identity=REMAT_IDENTITY)
    return Policy(param_dtype=dtype, compute_dtype=dtype), models, frozen, cfg


def make_train_batch(torch, n, res, seed):
    """[instance; class] images in [-1, 1], token ids and ground-truth embeddings."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {
        "pixel_values": torch.rand(n, res, res, 3, generator=g, device="cuda") * 2 - 1,
        "input_ids": torch.randint(0, 49408, (n, 77), generator=g, device="cuda"),
        "gt_embeds": torch.randn(n, 512, generator=g, device="cuda"),
    }


def _frozen_checksum(torch, frozen):
    with torch.no_grad():
        return sum(float(p.double().sum() + p.double().abs().sum()) for m in frozen.values() for p in m.parameters())


def _small_train_check(torch, op, label, variants, loss_tol=1e-2, cos_min=0.99, expect=None):
    """One loss and LoRA gradient on 2(+2) images of 128² with the same draws
    and a LoRA with nonzero B for each of the two `variants`, {name: (model
    bundle, GN route: GN_IMPL for both variables or (GN_IMPL, GN_CONV_IMPL))}:
    the losses within `loss_tol` relative, the
    gradients' cosine >= `cos_min`; the first variant's kernel launches
    exactly `expect` where given. Returns those launches."""
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.training import idbooth

    policy, models, frozen, cfg = op
    small = cfg.replace(train_batch_size=2, resolution=128)
    batch = make_train_batch(torch, 4, 128, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    lora = idbooth.init_trainable(4, small, models, frozen["unet"])
    leaves = idbooth.tree_leaves(lora)
    with torch.no_grad():
        for leaf in leaves[1::2]:  # the B factors
            leaf.copy_(0.01 * torch.randn(leaf.shape, generator=g, device="cuda"))
    draws = idbooth.draw((4, 16, 16, 4), 4, 1000, g, "cuda")
    got, launches = [], []
    for bundle, route in variants.values():
        _reset_launch_counts()
        with gn_route(*((route,) if isinstance(route, str) else route)):
            loss, _ = idbooth.make_loss_fn(small, bundle, make_ddpm(), policy)(lora, frozen, batch, draws=draws)
            grads = torch.autograd.grad(loss, leaves)
        got.append((float(loss.detach()), torch.cat([x.float().flatten() for x in grads])))
        launches.append({n: c for n, c in _launch_counts().items() if c})
    (loss_a, grad_a), (loss_b, grad_b) = got
    rel = abs(loss_a - loss_b) / abs(loss_b)
    cos = float(torch.nn.functional.cosine_similarity(grad_a, grad_b, dim=0))
    print(f"{label} at 2(+2)×128², {str(policy.compute_dtype)[6:]}: loss {loss_a:.8f} vs {loss_b:.8f} (rel diff "
          f"{rel:.3e}, limit {loss_tol}); LoRA gradient cosine {cos:.8f} (limit {cos_min}); launches "
          f"{json.dumps(launches[0])}", flush=True)
    if not (rel <= loss_tol and cos >= cos_min):
        fail(f"{label}: the two paths disagree")
    if expect is not None and launches[0] != expect:
        fail(f"{label}: the kernel path launched {launches[0]}, expected {expect}")
    return launches[0]


def _train_steps(torch, op, steps, expect, label, card_line):
    """`steps` train steps at the op point, each launching exactly `expect`,
    moving the LoRA and leaving the frozen weights untouched; the launch
    counts are set to 0 just before the first and read just after the last.
    Returns (launches, the fastest step after the first (the only one
    when there is one), the peak device memory in GiB)."""
    from faceposegenerator_tpu_torch.core.rng import train_step_generator
    from faceposegenerator_tpu_torch.training import idbooth

    policy, models, frozen, cfg = op
    trainable = idbooth.init_trainable(4, cfg, models, frozen["unet"])
    optimizer = idbooth.make_optimizer(cfg, total_steps=1000)
    opt_state = optimizer.init(trainable)
    step = idbooth.make_train_step(cfg, models, optimizer, policy=policy)
    batch = make_train_batch(torch, 8, 512, seed=5)
    checksum = _frozen_checksum(torch, frozen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    secs = []
    for i in range(steps):
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        trainable, opt_state, metrics = step(trainable, opt_state, frozen, batch,
                                             train_step_generator(cfg.seed, i, "cuda"))
        vals = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        per = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
        print(f"{label} step {i}: {secs[-1]:.3f} s, {json.dumps(vals)}, launches {json.dumps(per)} ({card_line})",
              flush=True)
        if not all(math.isfinite(v) for v in vals.values()) or set(vals) != {
                "loss", "instance_loss", "prior_loss", "id_loss", "grad_norm"} or not vals["grad_norm"] > 0:
            fail(f"{label} step {i}: metrics {vals}")
        if per != expect:
            fail(f"{label} step {i} launched {per}, expected {expect}")
    launches = _launch_counts()
    moved = max(float(leaf.detach().abs().max()) for leaf in idbooth.tree_leaves(trainable)[1::2])
    if not moved > 0:
        fail(f"{label}: no LoRA B factor moved off zero")
    if _frozen_checksum(torch, frozen) != checksum:
        fail(f"{label}: the frozen weights changed")
    steady = min(secs[1:] or secs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: bs4(+prior) 512² triplet_prior r100: {secs} s per step; steady {steady:.3f} s/step = "
          f"{4 / steady:.3f} train img/s; peak memory {peak:.1f} GiB; "
          f"LoRA B max {moved:.3e}; frozen weights unchanged ({card_line})", flush=True)
    return launches, steady, peak


def run_train(torch, card_line):
    """The train op point: the kernel path against the plain-attention path
    on a small input, then 3 steps. Returns (launches, the op point, the
    steady s/step, the peak memory in GiB)."""
    import dataclasses

    t0 = time.time()
    op = build_train_op_point(torch)
    models, cfg = op[1], op[3]
    torch.cuda.synchronize()
    print(f"train: op point built in {time.time() - t0:.1f} s (remat_identity={cfg.remat_identity})", flush=True)
    _small_train_check(torch, op, "train: kernels vs plain attention", {
        impl: (dataclasses.replace(models, attn_impl=impl), "xla") for impl in ("auto", "reference")})
    expect = dict(STEP_LAUNCHES, flash_fwd_wide=3 if cfg.remat_identity else 2)
    launches, steady, peak = _train_steps(torch, op, 3, expect, "train", card_line)
    return launches, op, steady, peak


def run_fused_txt2img(torch, card_line, default_secs):
    """The txt2img request in the fused configuration (GN_IMPL and
    GN_CONV_IMPL at pallas): the kernel routes against the default routes on
    a small input, then 2 requests with exact launch counts; then the same
    with GN_IMPL alone at pallas (K3 without K4), 1 request. Returns the
    phase's launch counts."""
    import numpy as np

    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    pipe.set_lora(make_lora(pipe.nets["unet"], 10, torch))
    ids = torch.randint(0, 49408, (8, 77), generator=torch.Generator().manual_seed(1))
    small = dict(input_ids=ids[:2], num_inference_steps=2, height=128, width=128, seed=5)
    want = pipe(**small)
    with gn_route("pallas"):
        got = pipe(**small)
    diff = np.abs(got - want)
    print(f"fused txt2img: built in {time.time() - t0:.1f} s; K3/K4 routes vs the default routes at 2×128², "
          f"2 steps, bf16: image diff max {diff.max():.3e} mean {diff.mean():.3e} (limits 1e-1, 1e-2)", flush=True)
    if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2):
        fail("the fused GroupNorm routes and the default routes disagree")

    images, secs = [], []
    with gn_route("pallas"):
        _reset_launch_counts()
        for r, seed in enumerate((0, 1)):
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0, height=512, width=512, seed=seed)
            secs.append(time.time() - t0)
            per = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
            print(f"fused txt2img request {r}: seed {seed}, {secs[-1]:.3f} s, {8 / secs[-1]:.3f} img/s, "
                  f"launches {json.dumps(per)} ({card_line})", flush=True)
            _check_images(img, 8, 512, f"fused txt2img request {r}")
            if per != FUSED_LAUNCHES:
                fail(f"fused txt2img request {r} launched {per}, expected {FUSED_LAUNCHES}")
            images.append(img)
        launches = _launch_counts()
    if float(np.abs(images[0] - images[1]).max()) < 1e-3:
        fail("fused txt2img: images do not differ between seeds")
    best = min(secs)
    print(f"fused txt2img: bs8 512² 30-step DDPM CFG 5.0: {secs} s per request; best {best:.3f} s = "
          f"{8 / best:.3f} img/s against the default configuration's {default_secs:.3f} s = "
          f"{8 / default_secs:.3f} img/s in this process ({card_line})", flush=True)

    # GN_IMPL alone at pallas (GN_CONV_IMPL at xla): K3 is the only GroupNorm kernel
    with gn_route("pallas", conv="xla"):
        got = pipe(**small)
    diff = np.abs(got - want)
    print(f"GN_IMPL alone: K3 route vs the default routes at 2×128², 2 steps, bf16: image diff max "
          f"{diff.max():.3e} mean {diff.mean():.3e} (limits 1e-1, 1e-2)", flush=True)
    if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2):
        fail("GN_IMPL alone: the K3 route and the default routes disagree")
    with gn_route("pallas", conv="xla"):
        _reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0, height=512, width=512, seed=0)
        alone_secs = time.time() - t0
        alone = _launch_counts()
    per = {n: c for n, c in alone.items() if c}
    print(f"GN_IMPL alone request: seed 0, {alone_secs:.3f} s = {8 / alone_secs:.3f} img/s against the default "
          f"configuration's {default_secs:.3f} s and the fused one's {best:.3f} s in this process, launches "
          f"{json.dumps(per)} ({card_line})", flush=True)
    _check_images(img, 8, 512, "GN_IMPL alone request")
    if per != GN_ALONE_LAUNCHES:
        fail(f"GN_IMPL alone request launched {per}, expected {GN_ALONE_LAUNCHES}")
    return {n: c + alone[n] for n, c in launches.items()}


def run_fused_train(torch, card_line, op, default_steady):
    """The train step at the op point `op` in the fused configuration: the
    kernel routes against the default routes at 2(+2)×128², then 2 steps
    with exact launch counts; then GN_IMPL alone at pallas (K4 at xla), the
    same gate and 1 step. Returns the phase's launch counts."""
    models, cfg = op[1], op[3]
    _small_train_check(torch, op, "fused train: K3/K4 routes vs the default routes",
                       {route: (models, route) for route in ("pallas", "xla")})
    expect = dict(FUSED_STEP_LAUNCHES, flash_fwd_wide=3 if cfg.remat_identity else 2)
    with gn_route("pallas"):
        launches, steady, _ = _train_steps(torch, op, 2, expect, "fused train", card_line)
    print(f"fused train: {steady:.3f} s/step against the default configuration's {default_steady:.3f} s/step "
          f"in this process ({card_line})", flush=True)
    _small_train_check(torch, op, "GN_IMPL alone train: K3 route vs the default routes",
                       {"alone": (models, ("pallas", "xla")), "xla": (models, "xla")})
    expect = dict(GN_ALONE_STEP_LAUNCHES, flash_fwd_wide=3 if cfg.remat_identity else 2)
    with gn_route("pallas", conv="xla"):
        alone, alone_s, _ = _train_steps(torch, op, 1, expect, "GN_IMPL alone train", card_line)
    print(f"GN_IMPL alone train: {alone_s:.3f} s/step (one step) against the default configuration's "
          f"{default_steady:.3f} and the fused one's {steady:.3f} in this process ({card_line})", flush=True)
    return {n: c + alone[n] for n, c in launches.items()}


class tf32:
    """Within the block, cuBLAS matmuls (`allow`) and cuDNN convolutions
    (`cudnn`, as `allow` unless given) may (True) or may not (False) round
    fp32 operands to TF32; the previous settings after."""

    def __init__(self, allow, cudnn=None):
        self.allow, self.cudnn = allow, allow if cudnn is None else cudnn

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.allow, self.cudnn

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _f32_errs(out, ref):
    """(max abs err, mean abs err, the reference's max abs, within the fp32 gate)."""
    max_err, mean_err = _err(out, ref)
    n = ref.float().abs().max().item()
    return max_err, mean_err, n, max_err <= F32_MAX_ERR * n and mean_err <= F32_MEAN_ERR * n


def check_f32_forward(torch, fa, card, shapes, with_lse=False, per="request"):
    """flash_fwd_f32 at `shapes` on fp32 unit-normal inputs against
    attention_plain(_lse) in fp32 with TF32 off, timed beside it, SDPA on the
    same fp32 tensors and the fp32 bound."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    with tf32(False):
        for label, b, h, sq, skv, d, per_run in shapes:
            q, k, v = _inputs(torch, g, b, h, sq, skv, d, torch.float32)
            scale = d**-0.5
            out = fa.flash_fwd_f32(q, k, v, scale, with_lse=with_lse)
            torch.cuda.synchronize()
            lse_err = None
            if with_lse:
                out, lse = out
                ref, ref_lse = fa.attention_plain_lse(q, k, v, scale)
                lse_err = (lse - ref_lse).abs().max().item()
            else:
                ref = fa.attention_plain(q, k, v, scale)
            max_err, mean_err, n, ok = _f32_errs(out, ref)
            del ref, out
            torch.cuda.empty_cache()
            plain = fa.attention_plain_lse if with_lse else fa.attention_plain
            ms = time_ms(lambda: fa.flash_fwd_f32(q, k, v, scale, with_lse=with_lse), torch)
            plain_ms = time_ms(lambda: plain(q, k, v, scale), torch)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), torch)
            flops = 4.0 * b * h * sq * skv * d
            bound_ms, bound_by = _bound(card, flops, 4.0 * b * h * d * (2 * sq + 2 * skv) + 4.0 * b * h * sq * with_lse,
                                        tf32x3=True)
            row = dict(kernel="flash_fwd_f32", shape=label, lse=with_lse, B=b, H=h, Sq=sq, Skv=skv, D=d, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_basis="3xTF32",
                       tflops=flops / ms * 1e-9, max_abs_err=max_err, mean_abs_err=mean_err, out_max_abs=n,
                       lse_max_err=lse_err, **{f"launches_per_{per}": per_run})
            print("kernel " + json.dumps(row), flush=True)
            rows.append(row)
            if not ok or (with_lse and not lse_err <= F32_LSE_ERR):
                fail(f"flash_fwd_f32 at {label}: max abs err {max_err} mean {mean_err} of max abs {n} "
                     f"(limits {F32_MAX_ERR}, {F32_MEAN_ERR} of it), lse err {lse_err}")
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def check_tf32_refused(torch, fa):
    """Attention at 80 × 4096² × 64 with TF32 allowed (the plain version's
    matmuls round q, k, p and v to 10 bits) must miss the fp32 gate, or the
    gate could not tell fp32 from TF32."""
    label, b, h, sq, skv, d, _ = SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = _inputs(torch, g, b, h, sq, skv, d, torch.float32)
    with tf32(False):
        ref = fa.attention_plain(q, k, v, d**-0.5)
    with tf32(True):
        approx = fa.attention_plain(q, k, v, d**-0.5)
    max_err, mean_err, n, ok = _f32_errs(approx, ref)
    print(f"fp32: TF32 attention at {label} B{b}: max abs err {max_err:.3e}, mean {mean_err:.3e} of max abs "
          f"{n:.3e} (the gate {F32_MAX_ERR}, {F32_MEAN_ERR} of it must refuse it)", flush=True)
    if ok:
        fail(f"the fp32 gate passes TF32 attention at {label} (max abs err {max_err}, mean {mean_err})")
    del q, k, v, ref, approx
    torch.cuda.empty_cache()
    return [max_err, mean_err, n]


def check_f32_backward(torch, fa, card, shapes):
    """The fp32 dK/dV and dQ passes at `shapes` on the fp32 forward's o and
    lse against attention_bwd_plain in fp32 with TF32 off, each gradient
    relative to its max abs; timed beside the plain backward and SDPA's fp32
    backward through autograd."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    with tf32(False):
        for label, b, h, sq, skv, d, per_step in shapes:
            q, k, v = _inputs(torch, g, b, h, sq, skv, d, torch.float32)
            do = torch.randn(b, sq, h, d, generator=g, device="cuda")
            scale = d**-0.5
            o, lse = fa.flash_fwd_f32(q, k, v, scale, with_lse=True)
            grads = fa.flash_bwd_f32(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            refs = fa.attention_bwd_plain(q, k, v, o, lse, do, scale)
            errs = [_f32_errs(x, r) for x, r in zip(grads, refs)]
            del refs, grads
            torch.cuda.empty_cache()
            ms = {p: time_ms(lambda p=p: fa.flash_bwd_f32(q, k, v, o, lse, do, scale, passes=(p,)), torch)
                  for p in ("dkv", "dq")}
            pair_ms = time_ms(lambda: fa.flash_bwd_f32(q, k, v, o, lse, do, scale), torch)
            plain_ms = time_ms(lambda: fa.attention_bwd_plain(q, k, v, o, lse, do, scale), torch)
            torch.cuda.empty_cache()
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
            dot = do.transpose(1, 2)
            library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), torch)
            del out, qt, kt, vt
            unit = b * h * sq * skv * d
            io = 4.0 * b * h * d
            pair_bound, pair_by = _bound(card, 10.0 * unit, io * (4 * sq + 4 * skv) + 8.0 * b * h * sq, tf32x3=True)
            dkv_bound, dkv_by = _bound(card, 8.0 * unit, io * (2 * sq + 4 * skv) + 8.0 * b * h * sq, tf32x3=True)
            dq_bound, dq_by = _bound(card, 6.0 * unit, io * (3 * sq + 2 * skv) + 8.0 * b * h * sq, tf32x3=True)
            row = dict(kernel="flash_bwd_f32", shape=label, B=b, H=h, Sq=sq, Skv=skv, D=d, bound_basis="3xTF32",
                       dkv_ms=ms["dkv"],
                       dq_ms=ms["dq"], pair_ms=pair_ms, plain_ms=plain_ms, library_ms=library_ms,
                       pair_bound_ms=pair_bound, pair_bound_by=pair_by, dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
                       dq_bound_ms=dq_bound, dq_bound_by=dq_by, tflops=10.0 * unit / pair_ms * 1e-9,
                       dkv_tflops=8.0 * unit / ms["dkv"] * 1e-9, dq_tflops=6.0 * unit / ms["dq"] * 1e-9,
                       **{f"{n}_err": list(e[:3]) for n, e in zip(("dq", "dk", "dv"), errs)},
                       launches_per_step=per_step)
            print("kernel " + json.dumps(row), flush=True)
            rows.append(row)
            for name, (mx, mean, n, ok) in zip(("dq", "dk", "dv"), errs):
                if not ok:
                    fail(f"flash_bwd_f32 {name} at {label}: max abs err {mx} mean {mean}, gradient max abs {n} "
                         f"(limits {F32_MAX_ERR} and {F32_MEAN_ERR} of it)")
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()
    return rows


def check_f32_split(torch, fa, card, shapes=SPLIT_SHAPES):
    """flash_f32_split at the fp32 attention's main-path shapes, one launch
    with the forward's or the backward's jobs on strided views of a fused
    q/k/v projection, against f32_split_plain, which it must match bit for
    bit; timed beside it, with its bound: each input read once, each hi/lo
    plane written once."""
    g = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for label, b, h, s, d, jobs in shapes:
        qkv = torch.randn(b, s, 3, h, d, generator=g, device="cuda")
        src = dict(zip("qkv", qkv.unbind(2)), do=torch.randn(b, s, h, d, generator=g, device="cuda"))
        specs = [(src[n], tr) for tr, n in jobs]
        outs = fa.f32_split(specs)
        torch.cuda.synchronize()
        err = max((o - fa.f32_split_plain(t, tr)).abs().max().item() for o, (t, tr) in zip(outs, specs))
        nbytes = 4.0 * sum(src[n].numel() for n in {n for _, n in jobs}) + 4.0 * sum(o.numel() for o in outs)
        del outs
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fa.f32_split(specs), torch)
        plain_ms = time_ms(lambda: [fa.f32_split_plain(t, tr) for t, tr in specs], torch)
        bound_ms, bound_by = _bound(card, 0.0, nbytes)
        row = dict(kernel="flash_f32_split", shape=label, B=b, H=h, S=s, D=d, jobs=len(jobs), ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   gb_per_s=nbytes / ms * 1e-6, max_abs_err=err)
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if err != 0.0:
            fail(f"flash_f32_split at {label}: differs from f32_split_plain by {err}")
        del qkv, src, specs
        torch.cuda.empty_cache()
    return rows


def check_conv_f32(torch, card, shapes, per):
    """gn_silu_conv3x3_f32 at `shapes` on fp32 x and weights
    (_conv_inputs cast to fp32) against gn_silu_conv3x3_plain in fp32 with
    TF32 off, timed (its weight pre-pass included) beside it, plain
    GroupNorm+SiLU with cuDNN's fp32 conv (TF32 off) and the 3xTF32 bound."""
    from faceposegenerator_tpu_torch.models.layers import conv2d
    from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
    from faceposegenerator_tpu_torch.ops.norms import group_norm_plain

    g = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    with tf32(False):
        for label, n, h, w, cin, cout, per_run in shapes:
            x, gamma, beta, conv = _conv_inputs(torch, g, n, h, w, cin, cout)
            x, conv = x.float(), conv.float()
            conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
            out = fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32)
            torch.cuda.synchronize()
            max_err, mean_err, nmax, ok = _f32_errs(out, fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight,
                                                                                   conv.bias, 32))
            del out
            torch.cuda.empty_cache()
            ms = time_ms(lambda: fgc.gn_silu_conv3x3(x, gamma, beta, conv, 32), torch)
            plain_ms = time_ms(lambda: fgc.gn_silu_conv3x3_plain(x, gamma, beta, conv.weight, conv.bias, 32), torch)
            library_ms = time_ms(lambda: conv2d(group_norm_plain(x, gamma, beta, 32, 1e-5, "silu"), conv), torch)
            m = n * h * w
            flops = 2.0 * m * cout * 9 * cin
            bound_ms, bound_by = _bound(card, flops, 4.0 * m * (cin + cout) + 36.0 * cin * cout + 4.0 * cout,
                                        tf32x3=True)
            row = dict(kernel="gn_silu_conv3x3_f32", shape=label, N=n, H=h, W=w, Cin=cin, Cout=cout, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_basis="3xTF32",
                       tflops=flops / ms * 1e-9, max_abs_err=max_err, mean_abs_err=mean_err, out_max_abs=nmax,
                       **{f"launches_per_{per}": per_run})
            print("kernel " + json.dumps(row), flush=True)
            rows.append(row)
            if not ok:
                fail(f"gn_silu_conv3x3_f32 at {label}: max abs err {max_err} mean {mean_err} of max abs {nmax}")
            del x, conv
            torch.cuda.empty_cache()
    return rows


def check_conv_split_f32(torch, card, shapes, per):
    """gn_conv_f32_split, the weight pre-pass of K4's fp32 instance, on the
    fp32 channels_last weights of `shapes` against weight_split_plain, which
    it must match bit for bit; timed beside it, with its bound: the weight
    read once, its hi and lo planes written once."""
    from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc

    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for label, _, _, _, cin, cout, per_run in shapes:
        w = (torch.randn(cout, cin, 3, 3, generator=g, device="cuda") * (9 * cin) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        out = fgc.weight_split(w)
        torch.cuda.synchronize()
        err = (out - fgc.weight_split_plain(w)).abs().max().item()
        del out
        ms = time_ms(lambda: fgc.weight_split(w), torch)
        plain_ms = time_ms(lambda: fgc.weight_split_plain(w), torch)
        nbytes = 12.0 * w.numel()
        bound_ms, bound_by = _bound(card, 0.0, nbytes)
        row = dict(kernel="gn_conv_f32_split", shape=f"{label} weight", Cin=cin, Cout=cout, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   gb_per_s=nbytes / ms * 1e-6, max_abs_err=err, **{f"launches_per_{per}": per_run})
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if err != 0.0:
            fail(f"gn_conv_f32_split at {label}: differs from weight_split_plain by {err}")
        del w
    return rows


def check_qdense_f32(torch, card):
    """qdense_f32 in both modes at the turbo dense shapes on fp32 x against
    qdense_plain (the same codes: within 1 fp32 ulp + 1e-3 relative), timed
    beside it, torch._int_mm on the pre-quantized x and fp32 F.linear with
    TF32 off (yardsticks), and the bound."""
    import torch.nn.functional as F

    from faceposegenerator_tpu_torch.ops import qdense as qd
    from faceposegenerator_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    with tf32(False):
        for label, m, k, n in QDENSE_SHAPES:
            x = torch.randn(m, k, generator=g, device="cuda")
            w = torch.randn(n, k, generator=g, device="cuda") * k**-0.5
            qw = quantize_weight(w)
            for mode in ("dynamic", "static"):
                a = float(x.abs().amax()) * 1.1 / 127.0 if mode == "static" else None
                out = qd.qdense_kernel(x, qw.q, qw.s, a)
                torch.cuda.synchronize()
                max_err, mean_err, over = _ulp_err(out, qd.qdense_plain(x, qw.q, qw.s, a))
                del out
                ms = time_ms(lambda: qd.qdense_kernel(x, qw.q, qw.s, a), torch)
                plain_ms = time_ms(lambda: qd.qdense_plain(x, qw.q, qw.s, a), torch)
                codes = qd.quantize(x, -1, a)[0].to(torch.int8)
                int_mm_ms = time_ms(lambda: torch._int_mm(codes, qw.q.t()), torch)
                linear_ms = time_ms(lambda: F.linear(x, w), torch)
                del codes
                bound_ms, bound_by = _bound(card, 2.0 * m * n * k, 4.0 * m * k + n * k + 4.0 * n + 4.0 * m * n,
                                            int8=True)
                row = dict(kernel="qdense_f32", shape=label, mode=mode, M=m, K=k, N=n, ms=ms, plain_ms=plain_ms,
                           int_mm_ms=int_mm_ms, f32_linear_ms=linear_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=max_err, mean_abs_err=mean_err, over_limit=over,
                           **_quant_pass(torch, qd, card, x, a))
                print("kernel " + json.dumps(row), flush=True)
                rows.append(row)
                if over:
                    fail(f"qdense_f32 {mode} at {label}: {over} outputs beyond 1 fp32 ulp + {INT8_REL_ERR} relative "
                         f"of the plain version (max abs err {max_err})")
            del x, w, qw
            torch.cuda.empty_cache()
    return rows


def check_int8_f32(torch, fa, card, shapes=INT8_SHAPES):
    """flash_int8_f32 at the UNet's attention shapes on fp32 inputs against
    attention_int8_plain (within 1 fp32 ulp + 1e-3 relative, mean abs err <=
    1e-4), timed beside it, flash_fwd_f32 and SDPA on the same tensors."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    with tf32(False):
        for label, b, h, sq, skv, d in shapes:
            q, k, v = _inputs(torch, g, b, h, sq, skv, d, torch.float32)
            scale = d**-0.5
            out = fa.flash_attention_int8(q, k, v, scale)
            torch.cuda.synchronize()
            max_err, mean_err, over = _ulp_err(out, fa.attention_int8_plain(q, k, v, scale))
            del out
            torch.cuda.empty_cache()
            ms = time_ms(lambda: fa.flash_attention_int8(q, k, v, scale), torch)
            plain_ms = time_ms(lambda: fa.attention_int8_plain(q, k, v, scale), torch)
            f32_ms = time_ms(lambda: fa.flash_fwd_f32(q, k, v, scale), torch)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), torch)
            bound_ms, bound_by = _bound(card, 4.0 * b * h * sq * skv * d, 4.0 * b * h * d * (2 * sq + 2 * skv),
                                        int8=True)
            row = dict(kernel="flash_int8_f32", shape=label, B=b, H=h, Sq=sq, Skv=skv, D=d, ms=ms, plain_ms=plain_ms,
                       f32_ms=f32_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
                       mean_abs_err=mean_err, over_limit=over, **_int8_launches(torch, fa, card, q, k, v, scale))
            print("kernel " + json.dumps(row), flush=True)
            rows.append(row)
            if over or mean_err > INT8_MEAN_ERR:
                fail(f"flash_int8_f32 at {label}: {over} outputs beyond 1 fp32 ulp + {INT8_REL_ERR} relative of the "
                     f"plain version, max abs err {max_err}, mean {mean_err} (limit {INT8_MEAN_ERR})")
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def run_fp32_pipeline(torch, card_line):
    """StableDiffusionPipeline.from_random() at its default dtype (fp32):
    the kernel path against the plain-attention path on a small input, the
    fused-GroupNorm and w8a8 + flash_int8 routes of the same pipeline on it
    (the fp32 instances of K4, K7 and K8), and 2 requests at batch 8, 512²,
    10 DDPM steps, CFG 5.0 with exact launch counts, then 2 such requests in
    the fused configuration (K3's and K4's fp32 instances). Returns the
    launch counts of the default requests, of the fused requests and of the
    small-input routes."""
    import numpy as np

    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0)
    if pipe.nets["unet"].conv_in.weight.dtype != torch.float32 or pipe.policy.compute_dtype != torch.float32:
        fail("from_random() is not fp32 at its default dtype")
    lora = make_lora(pipe.nets["unet"], 10, torch, torch.float32)
    pipe.set_lora(lora)
    ids = torch.randint(0, 49408, (8, 77), generator=torch.Generator().manual_seed(1))
    small = dict(input_ids=ids[:2], num_inference_steps=2, height=128, width=128, seed=5)
    _reset_launch_counts()
    img_k = pipe(**small)
    routes = {"auto": {n: c for n, c in _launch_counts().items() if c}}
    plain = StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl="reference"), pipe.policy)
    plain.set_lora(lora)
    diff = np.abs(img_k - plain(**small))
    print(f"fp32 pipeline: built in {time.time() - t0:.1f} s; kernels vs plain attention at 2×128², 2 steps: image "
          f"diff max {diff.max():.3e} mean {diff.mean():.3e} (limits {F32_IMG_MAX}, {F32_IMG_MEAN}); launches "
          f"{json.dumps(routes['auto'])}", flush=True)
    if not (diff.max() <= F32_IMG_MAX and diff.mean() <= F32_IMG_MEAN):
        fail("fp32: the kernel path and the plain-attention path disagree")
    _reset_launch_counts()
    with gn_route("pallas"):
        img_f = pipe(**small)
    routes["fused"] = {n: c for n, c in _launch_counts().items() if c}
    diff = np.abs(img_f - img_k)
    print(f"fp32 pipeline: K3/K4 routes vs the default routes at 2×128²: image diff max {diff.max():.3e} mean "
          f"{diff.mean():.3e} (limits {F32_IMG_MAX}, {F32_IMG_MEAN}); launches {json.dumps(routes['fused'])}",
          flush=True)
    if not (diff.max() <= F32_IMG_MAX and diff.mean() <= F32_IMG_MEAN) or not routes["fused"].get(
            "gn_silu_conv3x3_f32"):
        fail("fp32: the fused GroupNorm routes disagree with the default routes or missed K4's fp32 instance")

    images, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    for r, seed in enumerate((0, 1)):
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img = pipe(input_ids=ids, num_inference_steps=10, guidance_scale=5.0, height=512, width=512, seed=seed)
        secs.append(time.time() - t0)
        per = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
        print(f"fp32 request {r}: seed {seed}, {secs[-1]:.3f} s, {8 / secs[-1]:.3f} img/s, launches "
              f"{json.dumps(per)} ({card_line})", flush=True)
        _check_images(img, 8, 512, f"fp32 request {r}")
        if per != F32_REQUEST_LAUNCHES:
            fail(f"fp32 request {r} launched {per}, expected {F32_REQUEST_LAUNCHES}")
        images.append(img)
    launches = _launch_counts()
    if float(np.abs(images[0] - images[1]).max()) < 1e-3:
        fail("fp32: images do not differ between seeds")
    print(f"fp32 pipeline: bs8 512² 10-step DDPM CFG 5.0, fp32 weights and compute (TF32 off): {secs} s per request; "
          f"best {min(secs):.3f} s = {8 / min(secs):.3f} img/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card_line})", flush=True)

    # the fused fp32 request: K3's and K4's fp32 instances on the same pipeline
    fused_images, fused_secs = [], []
    with gn_route("pallas"):
        _reset_launch_counts()
        for r, seed in enumerate((0, 1)):
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = pipe(input_ids=ids, num_inference_steps=10, guidance_scale=5.0, height=512, width=512, seed=seed)
            fused_secs.append(time.time() - t0)
            per = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
            print(f"fp32 fused request {r}: seed {seed}, {fused_secs[-1]:.3f} s, {8 / fused_secs[-1]:.3f} img/s, "
                  f"launches {json.dumps(per)} ({card_line})", flush=True)
            _check_images(img, 8, 512, f"fp32 fused request {r}")
            if per != F32_FUSED_LAUNCHES:
                fail(f"fp32 fused request {r} launched {per}, expected {F32_FUSED_LAUNCHES}")
            fused_images.append(img)
        fused_launches = _launch_counts()
    if float(np.abs(fused_images[0] - fused_images[1]).max()) < 1e-3:
        fail("fp32 fused: images do not differ between seeds")
    diff = np.abs(fused_images[0] - images[0])
    print(f"fp32 fused pipeline: bs8 512² 10-step DDPM CFG 5.0 with GN_IMPL and GN_CONV_IMPL at pallas: "
          f"{fused_secs} s per request; best {min(fused_secs):.3f} s = {8 / min(fused_secs):.3f} img/s against the "
          f"default fp32 request's {min(secs):.3f} s = {8 / min(secs):.3f} img/s in this process; images at seed 0 "
          f"against the default request's: diff max {diff.max():.3e} mean {diff.mean():.3e} (limits {F32_IMG_MAX}, "
          f"{F32_IMG_MEAN}) ({card_line})", flush=True)
    if not (diff.max() <= F32_IMG_MAX and diff.mean() <= F32_IMG_MEAN):
        fail("fp32 fused: the fused request's images disagree with the default request's")

    # the fp32 instances of K7 and K8: the same pipeline quantized (w8a8,
    # dynamic scales) with the int8 attention, against their plain versions
    pipe.quantize("w8a8")
    q = StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl="flash_int8"), pipe.policy)
    q.set_lora(lora)
    _reset_launch_counts()
    got = q(**small)
    routes["w8a8 flash_int8"] = {n: c for n, c in _launch_counts().items() if c}
    with plain_route():
        want = q(**small)
    diff = np.abs(got - want)
    print(f"fp32 pipeline: w8a8 + flash_int8 kernel routes vs plain routes at 2×128², 2 steps: image diff max "
          f"{diff.max():.3e} mean {diff.mean():.3e} (limits 1e-1, 1e-2); launches "
          f"{json.dumps(routes['w8a8 flash_int8'])}", flush=True)
    if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2) or not all(
            routes["w8a8 flash_int8"].get(n) for n in ("qdense_f32", "flash_int8_f32")):
        fail("fp32: the w8a8 + flash_int8 routes disagree with their plain versions or missed a kernel")
    del pipe, plain, q
    torch.cuda.empty_cache()
    small_launches = {}
    for counts in routes.values():
        for n, c in counts.items():
            small_launches[n] = small_launches.get(n, 0) + c
    return launches, fused_launches, small_launches


def run_fp32_train(torch, card_line):
    """The train op point with fp32 frozen weights and an fp32 compute
    policy: one loss and LoRA gradient at 2(+2)×128² on the kernel path
    against the plain-attention path (loss within 1e-4 relative, cosine >=
    0.9999), the fp32 kernels' launches exact. Returns those launches."""
    import dataclasses

    t0 = time.time()
    op = build_train_op_point(torch, torch.float32)
    op[0].configure_backends()
    print(f"fp32 train: op point built in {time.time() - t0:.1f} s", flush=True)
    models = op[1]
    launches = _small_train_check(
        torch, op, "fp32 train: kernels vs plain attention",
        {impl: (dataclasses.replace(models, attn_impl=impl), "xla") for impl in ("auto", "reference")},
        loss_tol=1e-4, cos_min=0.9999, expect=F32_TRAIN_LAUNCHES)
    del op
    torch.cuda.empty_cache()
    return launches


# port module names → diffusers keys (the renames chip_smoke's emitter makes)
_DIFFUSERS_KEYS = [
    (r"\.blocks\.(\d+)\.", r".transformer_blocks.\1."), (r"\.ln([123])\.", r".norm\1."),
    (r"\.attn([12])\.(q|k|v)\.", r".attn\1.to_\2."), (r"\.attn([12])\.out\.", r".attn\1.to_out.0."),
    (r"\.ff_in\.", ".ff.net.0.proj."), (r"\.ff_out\.", ".ff.net.2."),
    (r"\.downsample\.", ".downsamplers.0.conv."), (r"\.upsample\.", ".upsamplers.0.conv."),
    (r"\.mid\.res([12])\.", lambda m: f".mid_block.resnets.{int(m.group(1)) - 1}."),
    (r"\.mid\.attn\.norm\.", ".mid_block.attentions.0.group_norm."),
    (r"\.mid\.attn\.(q|k|v)\.", r".mid_block.attentions.0.to_\1."), (r"\.mid\.attn\.out\.", ".mid_block.attentions.0.to_out.0."),
    (r"^\.(encoder|decoder)\.norm_out\.", r".\1.conv_norm_out."),
]
_CLIP_KEYS = [
    (r"^token_embedding$", "text_model.embeddings.token_embedding.weight"),
    (r"^position_embedding$", "text_model.embeddings.position_embedding.weight"),
    (r"^final_ln\.", "text_model.final_layer_norm."), (r"^layers\.(\d+)\.ln([12])\.", r"text_model.encoder.layers.\1.layer_norm\2."),
    (r"^layers\.(\d+)\.(q|k|v|out)\.", r"text_model.encoder.layers.\1.self_attn.\2_proj."),
    (r"^layers\.(\d+)\.(fc[12])\.", r"text_model.encoder.layers.\1.mlp.\2."),
]


def emit_diffusers(nets, torch):
    """{"unet" | "vae" | "text_encoder": {diffusers key: fp32 tensor}} of the
    port's networks (the JAX package has no writer of its own)."""
    import re

    out = {}
    for name, net in nets.items():
        rules = _CLIP_KEYS if name == "text_encoder" else _DIFFUSERS_KEYS
        sd = {}
        for key, p in net.named_parameters():
            key = "." + key if name != "text_encoder" else key
            for pat, rep in rules:
                key = re.sub(pat, rep, key)
            sd[key.lstrip(".")] = p.detach().float()
        out[name] = sd
    return out


def synthetic_vocab(words):
    """A byte-level vocab in CLIP's layout: the 256 byte tokens (0-255, "!"
    0), the same with "</w>" (256-511), merges that make each of `words` one
    token (512 on), bos 49406, eos 49407."""
    from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer, bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    merges = []
    for _ in range(20):
        tok = CLIPTokenizer(vocab, merges)
        split = [tok.bpe("".join(tok.byte_encoder[b] for b in w.encode("utf-8"))).split(" ") for w in words]
        if all(len(pieces) == 1 for pieces in split):
            return vocab, merges
        for pieces in split:
            cur = pieces[0]
            for t in pieces[1:]:
                if (cur, t) not in merges:
                    merges.append((cur, t))
                    vocab.setdefault(cur + t, len(vocab) - 2)
                cur += t
    fail("the synthetic vocab's merges did not converge")


def write_sd21_dir(root, pipe, torch, configs=None):
    """A diffusers SD2.1-base directory of `pipe`'s weights, as fp32
    safetensors under the file names SD2.1 ships, with its config.json
    files (`configs`, SD2.1-base's by default) and a tokenizer/. Returns the
    seconds spent writing."""
    import os

    from faceposegenerator_tpu_torch.bridge.safetensors_io import save_file

    t0 = time.time()
    files = {"unet": "diffusion_pytorch_model.safetensors", "vae": "diffusion_pytorch_model.safetensors",
             "text_encoder": "model.safetensors"}
    for sub, sd in emit_diffusers(pipe.nets, torch).items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        save_file(sd, os.path.join(root, sub, files[sub]), metadata={"format": "pt"})
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump((configs or SD21_CONFIGS)[sub], f)
        del sd
    words = sorted({w for p in PROMPTS + [NEGATIVE_PROMPT] for w in p.replace(",", " ").replace("-", " ").split()})
    vocab, merges = synthetic_vocab(words)
    tok = os.path.join(root, "tokenizer")
    os.makedirs(tok, exist_ok=True)
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(tok, "tokenizer_config.json"), "w") as f:
        json.dump({"pad_token": "!", "model_max_length": 77, "do_lower_case": True}, f)
    return time.time() - t0


class shape_tally:
    """Within the block, counts the attention forwards on the card by (B, H,
    Sq, Skv, D) as `ops.attention` (under no grad) and `FlashAttention`
    (under a gradient) hand them to the kernel wrapper, one launch each (the
    wrapper itself counts the launches): `shapes` those without the
    log-sum-exp, `lse` those with it."""

    def __enter__(self):
        from faceposegenerator_tpu_torch.ops import attention
        from faceposegenerator_tpu_torch.ops import flash_attention as fa

        self.saved = (attention.flash_fwd, fa.flash_fwd)
        self.shapes, self.lse = {}, {}

        def tally(fwd):
            def call(q, k, v, *a, **kw):
                if q.is_cuda:
                    key = (q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[-1])
                    counts = self.lse if kw.get("with_lse") else self.shapes
                    counts[key] = counts.get(key, 0) + 1
                return fwd(q, k, v, *a, **kw)

            return call

        attention.flash_fwd, fa.flash_fwd = (tally(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        from faceposegenerator_tpu_torch.ops import attention
        from faceposegenerator_tpu_torch.ops import flash_attention as fa

        attention.flash_fwd, fa.flash_fwd = self.saved


def _stack_loras(trees, torch):
    """Per-sample adapters: the leaves of `trees` stacked on a new axis 0."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        if isinstance(nodes[0], list):
            return [stack(list(x)) for x in zip(*nodes)]
        return None if nodes[0] is None else torch.stack(nodes)

    return stack(trees)


def _route_diff(got, want, label, limits=(1e-1, 1e-2)):
    import numpy as np

    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    print(f"{label}: image diff max {diff.max():.3e} mean {diff.mean():.3e} (limits {limits[0]:g}, {limits[1]:g})",
          flush=True)
    if not (diff.max() <= limits[0] and diff.mean() <= limits[1]):
        fail(f"{label}: beyond the limits")
    return float(diff.max()), float(diff.mean())


class build_dir:
    """A fresh directory `build/<name>` of the checkout within the block,
    removed after it, also when a check fails. With `parent`, the directory
    `<parent>/<name>` instead, left for a later phase (the parent's block
    removes it)."""

    def __init__(self, name, parent=None):
        from pathlib import Path

        self.keep = parent is not None
        self.path = str(Path(parent) / name if self.keep else Path(__file__).resolve().parent / "build" / name)

    def __enter__(self):
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)
        return self.path

    def __exit__(self, *exc):
        import shutil

        if not self.keep:
            shutil.rmtree(self.path, ignore_errors=True)


def run_checkpoints(torch, card_line, default_secs, root):
    """Phase 12: the synthetic SD2.1-base directory at `root`,
    from_pretrained, a LoRA file, prompts, num_images_per_prompt, per-sample
    adapters, ToMe, decode_chunk, the latency preset and its accel report,
    and the turbo preset calibrating by prompt, each request with exact
    launch counts. Returns the phase's launch counts and the launches a
    request measured at each of CKPT_SHAPES."""
    import dataclasses
    import os

    import numpy as np

    from faceposegenerator_tpu_torch.diffusion.lora_io import save_lora_safetensors
    from faceposegenerator_tpu_torch.evaluation.accel_report import compare_modes
    from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
    from faceposegenerator_tpu_torch.pipelines.presets import get_preset
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    t_phase = time.time()
    src = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    write_s = write_sd21_dir(root, src, torch)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    torch.cuda.synchronize()
    t0 = time.time()
    pipe = StableDiffusionPipeline.from_pretrained(root, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    print(f"checkpoints: wrote {size / 1e9:.2f} GB (fp32 safetensors, configs, tokenizer) in {write_s:.1f} s; "
          f"from_pretrained in {load_s:.1f} s ({card_line})", flush=True)
    m = pipe.models
    if (m.text_cfg, m.unet_cfg, m.vae_cfg) != (clip_text.SD21_TEXT_CONFIG, unet2d.SD21_UNET_CONFIG,
                                               vae.SD_VAE_CONFIG):
        fail(f"from_pretrained read configs {m} instead of SD2.1-base's")
    if pipe.tokenizer is None or pipe.tokenizer.pad_token_id != 0:
        fail("from_pretrained loaded no tokenizer, or not SD2's '!' padding")
    for name, net in pipe.nets.items():
        theirs = dict(src.nets[name].named_parameters())
        for key, p in net.named_parameters():
            if p.dtype != torch.bfloat16 or not torch.equal(p, theirs[key]):
                fail(f"{name}.{key} differs from the source pipeline's")
    long = [w for w in PROMPTS[0].replace(",", " ").split() if len(pipe.tokenizer.encode(w)) != 1]
    if long:
        fail(f"the synthetic vocab splits {long}")

    # a LoRA file in peft keys, loaded back
    tree = make_lora(src.nets["unet"], 13, torch)
    lora_dir = os.path.join(root, "lora")
    save_lora_safetensors(tree, os.path.join(lora_dir, "pytorch_lora_weights.safetensors"))
    pipe.load_lora_weights(lora_dir)
    src.set_lora(tree)
    _reset_launch_counts()

    def request(label, fn, expect, b=8, res=512):
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img = fn()
        secs = time.time() - t0
        per = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
        print(f"{label}: {secs:.3f} s, launches {json.dumps(per)} ({card_line})", flush=True)
        _check_images(img, b, res, label)
        if expect is not None and per != expect:
            fail(f"{label} launched {per}, expected {expect}")
        return img, secs

    req = dict(num_inference_steps=30, guidance_scale=5.0, height=512, width=512)
    img, secs = request("prompted request (8 prompts, negative prompt, LoRA file)",
                        lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0, **req), REQUEST_LAUNCHES)
    img2, secs2 = request("prompted request again", lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0,
                                                                 **req), REQUEST_LAUNCHES)
    ids, neg = pipe.tokenize(PROMPTS), pipe.tokenize([NEGATIVE_PROMPT])
    want, _ = request("source pipeline on the tokenized ids", lambda: src(input_ids=ids, negative_input_ids=neg,
                                                                          seed=0, **req), REQUEST_LAUNCHES)
    if not (np.array_equal(img, want) and np.array_equal(img2, img)):
        fail(f"the prompted images are not bit-equal to the source pipeline's on the same ids "
             f"(max diff {np.abs(img - want).max():.3e})")
    print(f"checkpoints: prompted request bit-equal to the source pipeline; {min(secs, secs2):.3f} s/request "
          f"against phase 4's {default_secs:.3f} ({card_line})", flush=True)
    del src
    torch.cuda.empty_cache()

    # num_images_per_prompt
    rep, _ = request("num_images_per_prompt=4 on 2 prompts",
                     lambda: pipe(PROMPTS[:2], negative_prompt=NEGATIVE_PROMPT, num_images_per_prompt=4, seed=1, **req),
                     REQUEST_LAUNCHES)
    rep_ids = pipe.tokenize(PROMPTS[:2]).repeat_interleave(4, 0)
    want, _ = request("the same on repeated ids", lambda: pipe(input_ids=rep_ids, negative_input_ids=neg, seed=1, **req),
                      REQUEST_LAUNCHES)
    if not np.array_equal(rep, want):
        fail("num_images_per_prompt is not bit-equal to the repeated ids")

    # per-sample adapters: one prompt and one noise for every slot, so the slots differ by adapter alone
    trees = [make_lora(pipe.nets["unet"], 20 + b, torch)["unet"] for b in range(8)]
    stacked = {"unet": _stack_loras(trees, torch), "text_encoder": None}
    scale = torch.tensor([1.0, 0.5, 1.0, 0.0, 0.8, 1.0, 0.3, 1.0], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)

    def same_noise(steps, b, res):
        return torch.randn(steps + 1, 1, res // 8, res // 8, 4, generator=g, device="cuda").expand(-1, b, -1, -1, -1)

    one = [PROMPTS[0]] * 8
    noise30 = same_noise(30, 8, 512)
    request("per-sample adapters (8, (8,) scale)", lambda: pipe(one, negative_prompt=NEGATIVE_PROMPT, lora=stacked,
                                                                lora_scale=scale, noise_override=noise30, **req),
            REQUEST_LAUNCHES)
    cmp = dict(req, num_inference_steps=10)
    noise10 = same_noise(10, 8, 512)
    per_sample = pipe(one, negative_prompt=NEGATIVE_PROMPT, lora=stacked, lora_scale=scale, noise_override=noise10, **cmp)
    for b in range(8):
        shared = pipe(one, negative_prompt=NEGATIVE_PROMPT, lora={"unet": trees[b], "text_encoder": None},
                      lora_scale=float(scale[b]), noise_override=noise10, **cmp)
        _route_diff(per_sample[b], shared[b], f"per-sample slot {b} (scale {float(scale[b]):g}) vs its shared adapter, "
                    "8×512², 10 steps")
    bare = pipe(one, negative_prompt=NEGATIVE_PROMPT, lora={"unet": None, "text_encoder": None},
                noise_override=noise10, **cmp)
    _route_diff(per_sample[3], bare[3], "per-sample zero-scale slot vs no LoRA")
    gaps = [float(np.abs(per_sample[a] - per_sample[b]).max()) for a in range(8) for b in range(a + 1, 8)
            if float(scale[a]) + float(scale[b]) > 0]
    print(f"per-sample slots: smallest max diff between two slots {min(gaps):.3e}", flush=True)
    if min(gaps) < 1e-3:
        fail("per-sample slots do not differ")
    # the turbo-shaped guidance interval: the cond-only steps take the adapters untiled
    small = dict(num_inference_steps=12, height=128, width=128, cfg_interval=(2, 8), deepcache_interval=4)
    noise_s = same_noise(12, 2, 128)
    two = {"unet": _stack_loras(trees[:2], torch), "text_encoder": None}
    got = pipe(one[:2], lora=two, lora_scale=scale[:2], noise_override=noise_s, **small)
    for b in range(2):
        shared = pipe(one[:2], lora={"unet": trees[b], "text_encoder": None}, lora_scale=float(scale[b]),
                      noise_override=noise_s, **small)
        _route_diff(got[b], shared[b], f"per-sample slot {b} under cfg_interval (2, 8), DeepCache-4, 2×128²")

    # ToMe at ratio 0.5: L0's self-attention at 2048 tokens
    with shape_tally() as tally:
        request("ToMe 0.5 request", lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0, tome_ratio=0.5, **req),
                REQUEST_LAUNCHES)
    _, tome_s = request("ToMe 0.5 request again", lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0,
                                                                tome_ratio=0.5, **req), REQUEST_LAUNCHES)
    with shape_tally() as xtally:
        _, xattn_s = request("ToMe 0.5 request, tome_ops attn,xattn",
                             lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0, tome_ratio=0.5,
                                          tome_ops="attn,xattn", **req), REQUEST_LAUNCHES)
    for label, t in (("attn", tally), ("attn,xattn", xtally)):
        print(f"ToMe 0.5 ({label}): launches by (B, H, Sq, Skv, D): "
              f"{json.dumps({str(k): v for k, v in t.shapes.items()})}", flush=True)
    print(f"ToMe 0.5: {tome_s:.3f} s/request (attn), {xattn_s:.3f} (attn,xattn), against {min(secs, secs2):.3f} "
          f"exact ({card_line})", flush=True)
    if tally.shapes.get((16, 5, 2048, 2048, 64), 0) != 150:
        fail(f"ToMe request ran K1 {tally.shapes.get((16, 5, 2048, 2048, 64), 0)} times at 80 × 2048², expected 150")
    tkw = dict(num_inference_steps=4, height=128, width=128, seed=3, tome_ratio=0.5, tome_min_tokens=256,
               tome_ops="attn,xattn,mlp")
    got = pipe(PROMPTS[:2], negative_prompt=NEGATIVE_PROMPT, **tkw)
    plain = StableDiffusionPipeline(pipe.nets, dataclasses.replace(pipe.models, attn_impl="reference"), pipe.policy,
                                    tokenizer=pipe.tokenizer)
    plain.set_lora(pipe.lora)
    _route_diff(got, plain(PROMPTS[:2], negative_prompt=NEGATIVE_PROMPT, **tkw),
                "ToMe (attn, xattn, mlp) kernels vs plain attention at 2×128², 4 steps")

    # decode_chunk=2: K2 four times at 2 × 4096² × 512
    for r in range(2):
        with shape_tally() as ctally:
            chunked, chunk_s = request(f"decode_chunk=2 request {r}",
                                       lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0, decode_chunk=2,
                                                    **req), dict(REQUEST_LAUNCHES, flash_fwd_wide=4))
    # the launches a request at each of phase 3's phase-12 shapes, as measured here
    measured = {}
    for (name, b, h, sq, skv, d, want), t in zip(CKPT_SHAPES, (tally, xtally, ctally)):
        measured[name] = t.shapes.get((b, h, sq, skv, d), 0)
        if measured[name] != want:
            fail(f"{name}: {measured[name]} launches a request at {b} × {h} × {sq} × {skv} × {d}, expected {want}")
    print(f"checkpoints: launches a request at the new shapes {json.dumps(measured)} ({card_line})", flush=True)
    print(f"decode_chunk=2: {chunk_s:.3f} s/request against {min(secs, secs2):.3f} whole ({card_line})", flush=True)
    # cuDNN picks its conv algorithms per batch size, so batch 2 may round otherwise than batch 8
    _route_diff(chunked, img, "decode_chunk=2 vs the whole batch (same request)")

    # the latency preset at batch 1, then its accel report
    kw = get_preset("latency").apply(pipe)
    lat = [request(f"latency preset request {r} (batch 1)", lambda r=r: pipe(PROMPTS[r], negative_prompt=NEGATIVE_PROMPT,
                                                                              seed=r, num_inference_steps=20, **kw,
                                                                              height=512, width=512),
                   LATENCY_LAUNCHES, b=1)[1] for r in range(3)]
    print(f"latency preset: batch 1, 512², DPM++ 20, DeepCache-3, cfg_interval (3, 13): {lat} s per request; "
          f"best {min(lat):.3f} s ({card_line})", flush=True)
    pipe.set_scheduler("ddpm")
    spec = get_preset("latency").mode_spec()
    report = compare_modes(pipe, [spec], prompts=PROMPTS[:2], seed_floor=True)
    entry, floor = report["modes"][spec], report["seed_floor"]
    print(f"accel report ({spec} vs exact, 2 prompts, 512²): psnr {[float(v) for v in entry['psnr_db']]} "
          f"(mean {entry['psnr_mean']}); "
          f"seed floor mean {floor['psnr_mean']} min {floor['psnr_min']}; batch s exact "
          f"{report['exact']['batch_s']} mode {entry['batch_s']}", flush=True)
    if not all(v is not None and math.isfinite(v) for v in entry["psnr_db"]) or floor["psnr_mean"] is None:
        fail("the accel report's PSNRs are not finite")
    if not entry["psnr_mean"] > floor["psnr_mean"]:
        fail(f"the latency mode's PSNR {entry['psnr_mean']} is not above the seed floor {floor['psnr_mean']}")

    # last, as quantize is for good: the turbo preset calibrating through the tokenizer
    before = _launch_counts()
    t0 = time.time()
    kw = get_preset("turbo").apply(pipe)
    torch.cuda.synchronize()
    calib = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
    print(f"turbo by prompt: calibrated on CALIBRATION_PROMPT in {time.time() - t0:.1f} s, launches "
          f"{json.dumps(calib)} ({card_line})", flush=True)
    if calib.get("qdense") != TURBO_CALIB_LAUNCHES["qdense"]:
        fail(f"turbo calibration by prompt launched {calib}, expected qdense {TURBO_CALIB_LAUNCHES['qdense']}")
    request("turbo request by prompt", lambda: pipe(PROMPTS, negative_prompt=NEGATIVE_PROMPT, seed=0,
                                                    num_inference_steps=12, height=512, width=512, **kw),
            TURBO_LAUNCHES["auto"])
    launches = _launch_counts()
    del pipe, plain
    torch.cuda.empty_cache()
    print(f"checkpoints: phase 12 in {time.time() - t_phase:.1f} s ({card_line})", flush=True)
    return launches, measured


# Phase 13: validation samples 4 images with CFG, 25 DPM-Solver++ steps,
# every step one UNet pass on 8 rows (32 K1), then one VAE decode of the 4
# (1 K2); CLIP's attention is plain. A class-image request at batch 4 and
# 30 DDPM steps: 30 × 32 K1 and 1 K2.
VALIDATION_LAUNCHES = {"flash_fwd_d64": 25 * 32, "flash_fwd_wide": 1}
CLASS_LAUNCHES = {"flash_fwd_d64": 30 * 32, "flash_fwd_wide": 1}


class step_probe:
    """Within the block, every step that the factory `module.<name>` makes
    (`make_train_step`, `make_multi_train_step`), or every call of the
    function `module.<name>` with `factory=False`, is timed between two
    synchronisations and its kernel launches counted: `records` holds one
    {"s", "start", "end", "launches"} a call, in order."""

    def __init__(self, module, name, factory=True):
        self.module, self.name, self.factory = module, name, factory
        self.records = []

    def _timed(self, fn):
        import torch

        def call(*args, **kw):
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            t1 = time.time()
            launches = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
            self.records.append({"s": t1 - t0, "start": t0, "end": t1, "launches": launches})
            return out

        return call

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        if self.factory:
            setattr(self.module, self.name, lambda *a, **kw: self._timed(self.saved(*a, **kw)))
        else:
            setattr(self.module, self.name, self._timed(self.saved))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


class save_probe:
    """Within the block, CheckpointManager.save is timed and what it saves
    (trainable, opt_state) is kept as copies on the card, in `saves`."""

    def __enter__(self):
        import torch

        from faceposegenerator_tpu_torch.core.checkpointing import CheckpointManager
        from faceposegenerator_tpu_torch.core.tree import tree_map

        self.saved, self.saves = CheckpointManager.save, []

        def save(mgr, epoch, step, trainable, opt_state, *a, **kw):
            keep = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
            copy = {"trainable": tree_map(keep, trainable), "opt_state": tree_map(keep, opt_state)}
            torch.cuda.synchronize()
            t0 = time.time()
            path = self.saved(mgr, epoch, step, trainable, opt_state, *a, **kw)
            self.saves.append({"path": path, "s": time.time() - t0, **copy})
            return path

        CheckpointManager.save = save
        return self

    def __exit__(self, *exc):
        from faceposegenerator_tpu_torch.core.checkpointing import CheckpointManager

        CheckpointManager.save = self.saved


def _tree_equal(torch, a, b):
    from faceposegenerator_tpu_torch.core.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x.detach(), y.detach()) for x, y in zip(la, lb))


def _write_faces(torch, folder, n, res, seed):
    """n smooth random RGB images of res² as JPEG files (a 16² field upsampled)."""
    import os

    import numpy as np
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    field = torch.nn.functional.interpolate(torch.rand(n, 3, 16, 16, generator=g), size=(res, res), mode="bicubic")
    arr = (field.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()
    for i in range(n):
        Image.fromarray(np.ascontiguousarray(arr[i])).save(os.path.join(folder, f"{i}.jpg"))


def _embed_folder(torch, arcface, policy, folder, out_dir=None):
    """ArcFace r100 embeddings of a folder's images on the full-image crop:
    one `<stem>.npy` each into `out_dir`; returns them (n, 512)."""
    import os

    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.data.dreambooth import list_images
    from faceposegenerator_tpu_torch.ops.image import crop_and_resize, normalize_to_arcface
    from faceposegenerator_tpu_torch.training.idbooth import full_image_boxes

    names = list_images(folder)
    img = torch.from_numpy(np.stack([np.asarray(Image.open(os.path.join(folder, f)).convert("RGB"), np.float32)
                                     for f in names])).cuda()
    with torch.no_grad():
        boxes, _ = full_image_boxes(img)
        emb = arcface(normalize_to_arcface(crop_and_resize(img, boxes, 112)), policy).float().cpu().numpy()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        for f, e in zip(names, emb):
            np.save(os.path.join(out_dir, os.path.splitext(f)[0] + ".npy"), e)
    return emb


def _probe_summary(records, label, expect, card_line):
    """Each call's launches must be `expect`; returns the seconds a call."""
    for i, r in enumerate(records):
        if r["launches"] != expect:
            fail(f"{label} {i} launched {r['launches']}, expected {expect}")
    secs = [round(r["s"], 4) for r in records]
    print(f"{label}: {len(records)} calls, {secs} s, each launching {json.dumps(expect)} ({card_line})", flush=True)
    return secs


def run_driver(torch, card_line, model_dir, work, train_secs, train_peak):
    """Phase 13: the ID-Booth driver on phase 12's synthetic SD2.1-base
    directory (loaded again by from_pretrained: phase 12 quantized its
    pipeline for good) with the ArcFace r100 of the train op point, bf16
    frozen nets, fp32 LoRA, triplet_prior; its files under `work`. Class
    images, run_identity, resume, the exported LoRA in the pipeline, the
    stacked K = 2 run and accumulation with the text-encoder LoRA, each
    with exact launch counts. Returns the phase's launch counts and the
    least s/step of run_identity after its first step."""
    import os

    import numpy as np

    from faceposegenerator_tpu_torch.core.checkpointing import CheckpointManager
    from faceposegenerator_tpu_torch.core.rng import train_step_generator
    from faceposegenerator_tpu_torch.diffusion.lora_io import zero_lora
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.models import iresnet
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
    from faceposegenerator_tpu_torch.training import idbooth, idbooth_driver, multi_identity

    t_phase = time.time()
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16)
    policy, m = pipe.policy, pipe.models
    models = idbooth.ModelBundle(text_cfg=m.text_cfg, unet_cfg=m.unet_cfg, vae_cfg=m.vae_cfg,
                                 arcface_cfg=iresnet.config_for("r100"))
    frozen = dict(pipe.nets, arcface=iresnet.IResNet(models.arcface_cfg, dtype=torch.bfloat16, seed=3))
    checksum = _frozen_checksum(torch, frozen)
    total = {n: 0 for n in _launch_counts()}

    def add(counts):
        for n, c in counts.items():
            total[n] += c

    # 1. class images through the pipeline, instance images from a seed, their embeddings
    class_dir, src, embeds = (os.path.join(work, d) for d in ("class", "src", "embeds"))
    _reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    n_made = idbooth_driver.generate_class_images(pipe, class_dir, "photo of a person", 8, batch_size=4,
                                                  num_inference_steps=30)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    launches = {n: c for n, c in _launch_counts().items() if c}
    want = {n: 2 * c for n, c in CLASS_LAUNCHES.items()}
    print(f"driver: generate_class_images: {n_made} class images at 512² (2 requests at batch 4, 30 DDPM steps) "
          f"in {gen_s:.3f} s, launches {json.dumps(launches)} ({card_line})", flush=True)
    if n_made != 8 or len(os.listdir(class_dir)) != 8 or launches != want:
        fail(f"generate_class_images made {n_made} images, launched {launches}, expected 8 and {want}")
    add(_launch_counts())
    for ident, seed in (("id_a", 30), ("id_b", 31)):
        _write_faces(torch, os.path.join(src, ident), 4, 512, seed)
        _embed_folder(torch, frozen["arcface"], policy, os.path.join(src, ident), os.path.join(embeds, ident))
    np.save(os.path.join(work, "class_embed.npy"), _embed_folder(torch, frozen["arcface"], policy, class_dir).mean(0))

    # 2. run_identity: 2 epochs of 2 steps (8 rows: 4 instance + 4 class images), validation after the second
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", train_batch_size=4, num_train_epochs=2,
                                checkpointing_epochs=1, checkpoints_total_limit=1, validation_epochs=2,
                                num_validation_images=4)
    out = os.path.join(work, "out", "id_a")
    kw = dict(tokenizer=pipe.tokenizer, embeds_dir=os.path.join(embeds, "id_a"), class_dir=class_dir, policy=policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with step_probe(idbooth, "make_train_step") as steps, \
            step_probe(idbooth_driver, "validation_images", factory=False) as val, save_probe() as saves:
        t0 = time.time()
        trainable, history = idbooth_driver.run_identity(cfg, models, frozen, os.path.join(src, "id_a"), out, **kw)
        run_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    add(_launch_counts())
    step_s = _probe_summary(steps.records, "driver: run_identity step", STEP_LAUNCHES, card_line)
    val_s = _probe_summary(val.records, "driver: validation (4 images, 25 DPM-Solver++ steps, CFG)",
                           VALIDATION_LAUNCHES, card_line)
    # the host's time between two steps of an epoch: the next batch's JPEG decodes, resizes and copy
    gaps = [b["start"] - a["end"] for a, b in zip(steps.records, steps.records[1:])][::2]
    write_s = [round(sv["s"], 4) for sv in saves.saves]
    names = sorted(os.listdir(out))
    print(f"driver: run_identity 2 epochs in {run_s:.2f} s, history {json.dumps(history)}; files {names}; "
          f"checkpoint writes {write_s} s; peak memory {peak:.1f} GiB ({card_line})", flush=True)
    if len(steps.records) != 4 or len(val.records) != 1 or len(history) != 2:
        fail(f"run_identity ran {len(steps.records)} steps and {len(val.records)} validations, expected 4 and 1")
    if [n for n in names if n.startswith("checkpoint-")] != ["checkpoint-1-4"]:
        fail(f"run_identity left {names}: only the newest checkpoint should remain")
    if not os.path.exists(os.path.join(out, "validation", "epoch_1.png")):
        fail("run_identity wrote no validation grid")
    moved = max(float(leaf.detach().abs().max()) for leaf in idbooth.tree_leaves(trainable)[1::2])
    if not moved > 0 or _frozen_checksum(torch, frozen) != checksum:
        fail(f"run_identity: LoRA B max {moved}, or the frozen weights changed")

    # 3. the latest checkpoint read back bit-equal, then resumed to 3 epochs: one more epoch
    mgr = CheckpointManager(out, cfg.checkpoints_total_limit)
    template = idbooth.init_trainable(0, cfg, models, frozen["unet"])
    torch.cuda.synchronize()
    t0 = time.time()
    t_back, o_back, epoch, step = mgr.restore(mgr.latest(), template, idbooth.make_optimizer(cfg, 1).init(template))
    torch.cuda.synchronize()
    read_s = time.time() - t0
    last = saves.saves[-1]
    same = (_tree_equal(torch, t_back, last["trainable"]) and o_back["count"] == last["opt_state"]["count"] == 4
            and all(_tree_equal(torch, o_back[k], last["opt_state"][k]) for k in ("exp_avg", "exp_avg_sq")))
    print(f"driver: checkpoint {os.path.basename(mgr.latest())} read in {read_s:.3f} s: trainable, AdamW's "
          f"exp_avg and exp_avg_sq and the update count bit-equal to what was saved: {same} ({card_line})",
          flush=True)
    if not same or (epoch, step) != (1, 4):
        fail("the checkpoint read back differs from what was saved")
    _reset_launch_counts()
    with step_probe(idbooth, "make_train_step") as steps2, \
            step_probe(idbooth_driver, "validation_images", factory=False) as val2:
        trainable, history2 = idbooth_driver.run_identity(cfg.replace(num_train_epochs=3), models, frozen,
                                                          os.path.join(src, "id_a"), out, resume=True, **kw)
    add(_launch_counts())
    step_s += _probe_summary(steps2.records, "driver: resumed step", STEP_LAUNCHES, card_line)
    val_s += _probe_summary(val2.records, "driver: resumed validation", VALIDATION_LAUNCHES, card_line)
    gaps += [b["start"] - a["end"] for a, b in zip(steps2.records, steps2.records[1:])][::2]
    print(f"driver: resumed with num_train_epochs=3: history {json.dumps(history2)} ({card_line})", flush=True)
    if len(steps2.records) != 2 or len(history2) != 1 or history2[0]["epoch"] != 2:
        fail(f"the resumed run ran {len(steps2.records)} steps, {len(history2)} epochs: expected one epoch")

    # 4. the exported LoRA in the pipeline, bit-equal to the trainable cast as load_lora_weights casts it
    req = dict(prompt=[cfg.validation_prompt] * 4, num_inference_steps=30, height=512, width=512, seed=0)
    _reset_launch_counts()
    pipe.load_lora_weights(out)
    loaded = pipe(**req)
    cast = idbooth.tree_map(lambda t: t.detach().to(torch.bfloat16), trainable["unet_lora"])
    pipe.set_lora({"unet": cast, "text_encoder": zero_lora(frozen["unet"], frozen["text_encoder"], 4,
                                                           torch.bfloat16)["text_encoder"]})
    direct = pipe(**req)
    pipe.unload_lora_weights()
    counts = {n: c for n, c in _launch_counts().items() if c}
    add(_launch_counts())
    _check_images(loaded, 4, 512, "exported LoRA request")
    print(f"driver: load_lora_weights request (4 × 512², 30 steps) bit-equal to set_lora of the cast trainable: "
          f"{np.array_equal(loaded, direct)}; launches of both {json.dumps(counts)} ({card_line})", flush=True)
    if not np.array_equal(loaded, direct) or counts != {n: 2 * c for n, c in CLASS_LAUNCHES.items()}:
        fail("the exported LoRA request is not bit-equal to set_lora, or launched otherwise")

    # 5. two identities stacked: a 128² gate against serial steps, then an epoch at 512²
    small = cfg.replace(train_batch_size=2, resolution=128)
    g = torch.Generator(device="cuda").manual_seed(8)
    loras, batches, draws = [], [], []
    for k in range(2):
        lora = idbooth.init_trainable(4, small, models, frozen["unet"])
        with torch.no_grad():
            for leaf in idbooth.tree_leaves(lora)[1::2]:
                leaf.copy_(0.01 * torch.randn(leaf.shape, generator=g, device="cuda"))
        loras.append(lora)
        batches.append(make_train_batch(torch, 4, 128, seed=40 + k))
        draws.append(idbooth.draw((4, 16, 16, 4), 4, 1000, g, "cuda"))
    stacked = multi_identity.stack_pytrees(loras)
    loss, metrics = idbooth.make_loss_fn(small, models, make_ddpm(), policy, identities=2)(
        stacked, frozen, {k: torch.stack([b[k] for b in batches]) for k in batches[0]}, draws=draws)
    grads = torch.autograd.grad(loss, idbooth.tree_leaves(stacked))
    serial_fn = idbooth.make_loss_fn(small, models, make_ddpm(), policy)
    for k in range(2):
        loss_k, _ = serial_fn(loras[k], frozen, batches[k], draws=draws[k])
        grads_k = torch.autograd.grad(loss_k, idbooth.tree_leaves(loras[k]))
        loss_k = float(loss_k.detach())
        rel = abs(float(metrics["loss"][k]) - loss_k) / abs(loss_k)
        cos = float(torch.nn.functional.cosine_similarity(torch.cat([x[k].flatten() for x in grads]),
                                                          torch.cat([x.flatten() for x in grads_k]), dim=0))
        print(f"driver: stacked identity {k} vs its serial step at 2(+2)×128²: loss {float(metrics['loss'][k]):.8f} "
              f"vs {loss_k:.8f} (rel diff {rel:.3e}, limit 1e-2); LoRA gradient cosine {cos:.8f} "
              f"(limit 0.99)", flush=True)
        if not (rel <= 1e-2 and cos >= 0.99):
            fail(f"stacked identity {k} disagrees with its serial step")
    del stacked, grads, loss
    mcfg = cfg.replace(train_batch_size=2, num_train_epochs=1)
    outs = [os.path.join(work, "out", "stacked", ident) for ident in ("id_a", "id_b")]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    with step_probe(multi_identity, "make_multi_train_step") as msteps:
        t_list, hists = multi_identity.run_identities_vmapped(
            mcfg, models, frozen, [os.path.join(src, i) for i in ("id_a", "id_b")], outs, tokenizer=pipe.tokenizer,
            embeds_dirs=[os.path.join(embeds, i) for i in ("id_a", "id_b")], class_dir=class_dir, policy=policy)
    mpeak = torch.cuda.max_memory_allocated() / 2**30
    add(_launch_counts())
    mstep_s = _probe_summary(msteps.records, "driver: stacked step (2 identities × (2 + 2) rows)", STEP_LAUNCHES,
                             card_line)
    diff = max(float((a - b).abs().max()) for a, b in zip(idbooth.tree_leaves(t_list[0]),
                                                           idbooth.tree_leaves(t_list[1])))
    files = [sorted(os.listdir(o)) for o in outs]
    print(f"driver: run_identities_vmapped 1 epoch: histories {json.dumps(hists)}; LoRAs differ by {diff:.3e}; "
          f"files {files}; peak memory {mpeak:.1f} GiB ({card_line})", flush=True)
    if len(msteps.records) != 4 or not diff > 0:
        fail(f"the stacked run took {len(msteps.records)} steps (expected 4), LoRA difference {diff}")
    for f in files:
        if "checkpoint-0-4" not in f or "pytorch_lora_weights.safetensors" not in f:
            fail(f"a stacked identity lacks its checkpoint or export: {f}")

    # 6. gradient accumulation over 2 micro-steps at the op point: 2 micro-steps of the UNet LoRA
    # alone, then 4 with the text-encoder LoRA (CLIP with its gradient)
    batch = make_train_batch(torch, 8, 512, seed=5)
    clip_sum = _frozen_checksum(torch, {"t": frozen["text_encoder"]})
    acc = {}
    for label, text, micro in (("accumulation", False, 2), ("accumulation with the text LoRA", True, 4)):
        acfg = cfg.replace(gradient_accumulation_steps=2, train_text_encoder=text)
        trainable = idbooth.init_trainable(0, acfg, models, frozen["unet"], frozen["text_encoder"])
        optimizer = idbooth.make_optimizer(acfg, total_steps=1000)
        opt_state = optimizer.init(trainable)
        trees = ("unet_lora", "text_lora") if text else ("unet_lora",)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        with step_probe(idbooth, "make_train_step") as asteps:
            step = idbooth.make_train_step(acfg, models, optimizer, policy=policy)
            for i in range(micro):
                before = idbooth.tree_map(lambda t: t.detach().clone(), trainable)
                trainable, opt_state, metrics = step(trainable, opt_state, frozen, batch,
                                                     train_step_generator(acfg.seed, i, "cuda"))
                same = {tree: _tree_equal(torch, trainable[tree], before[tree]) for tree in trees}
                print(f"driver: {label} micro-step {i + 1}: loss {float(metrics['loss']):.6f}, LoRA unchanged "
                      f"{json.dumps(same)}, update count {opt_state['count']}", flush=True)
                if any(same.values()) != (i % 2 == 0) or all(same.values()) != (i % 2 == 0):
                    fail(f"{label} micro-step {i + 1}: LoRA unchanged {same}, expected {i % 2 == 0} for each")
        acc[label] = (_probe_summary(asteps.records, f"driver: {label} micro-step", STEP_LAUNCHES, card_line),
                      torch.cuda.max_memory_allocated() / 2**30)
        add(_launch_counts())
    if _frozen_checksum(torch, {"t": frozen["text_encoder"]}) != clip_sum or _frozen_checksum(torch, frozen) != checksum:
        fail("CLIP's frozen weights (or another frozen net's) changed")
    (acc_s, apeak), (acc0_s, apeak0) = acc["accumulation with the text LoRA"], acc["accumulation"]

    # the driver's step: the probed step plus the host's load of the next batch
    drv = [s + gap for s, gap in zip(step_s[1::2], gaps)]
    print(f"driver: s/step at the op point (bs4 + prior, 512², triplet_prior, r100) against phase 7's bare step "
          f"{train_secs:.3f} s (peak {train_peak:.1f} GiB): driver {min(drv):.3f} s (step {min(step_s[1:]):.3f} + "
          f"batch load {min(gaps):.3f}), peak {peak:.1f} GiB; stacked K = 2 {min(mstep_s[1:]):.3f} s, peak "
          f"{mpeak:.1f} GiB; accumulation micro-step {min(acc0_s[1:]):.3f} s, peak {apeak0:.1f} GiB, with the text "
          f"LoRA {min(acc_s[1:]):.3f} s, peak {apeak:.1f} GiB; "
          f"validation {min(val_s):.3f} s; checkpoint write {min(write_s):.3f} s, read {read_s:.3f} s; class images "
          f"{gen_s:.3f} s for 8 ({card_line})", flush=True)
    del pipe, frozen
    torch.cuda.empty_cache()
    print(f"driver: phase 13 in {time.time() - t_phase:.1f} s ({card_line})", flush=True)
    return total, min(step_s[1:])


# Phase 14: the batch engine's requests (30 DDPM steps, batch 8) launch
# phase 4's counts a batch; the rolling engine's tick is one UNet pass on
# 2 × 4 slots (32 K1) and each finished slot one batch-1 decode (1 K2); the
# packed sweep runs 3 × 21 prompts in 8 batches of 8.
SERVE_BATCH_LAUNCHES = REQUEST_LAUNCHES
TICK_LAUNCHES = {"flash_fwd_d64": 32}
DECODE1_LAUNCHES = {"flash_fwd_wide": 1}
SWEEP_LAUNCHES = {"flash_fwd_d64": 8 * 960, "flash_fwd_wide": 8}
SERVED = dict(num_inference_steps=30, guidance_scale=5.0, height=512, width=512)


def _u8_diff(got, want, label, limits=(1e-1, 1e-2)):
    """Two uint8 images: the largest code difference and the share of
    pixels that differ, printed; equal, or within `limits` on [0, 1]."""
    import numpy as np

    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d.max(axis=-1) > 0).mean())
    print(f"{label}: uint8 max diff {int(d.max())}, {100 * share:.3f}% of pixels differ", flush=True)
    if d.max() > 0:
        _route_diff(got.astype(np.float32) / 255.0, want.astype(np.float32) / 255.0, label)
    return int(d.max()), share


def _wait_ticks(records, n, futs, timeout=300.0):
    """Until the rolling engine has ticked n times, or has served `futs`; a
    request that failed meanwhile raises its error here."""
    deadline = time.time() + timeout
    while len(records) < n:
        if all(f.done() for f in futs):
            return [f.result() for f in futs]
        if time.time() > deadline:
            fail(f"the rolling engine ticked {len(records)} times in {timeout} s, expected {n}")
        time.sleep(0.005)


def _expect_each(records, expect, label):
    for i, r in enumerate(records):
        if r["launches"] != expect:
            fail(f"{label} {i} launched {r['launches']}, expected {expect}")


def run_serving(torch, card_line, model_dir, work, default_secs):
    """Phase 14: serving and the packed sweep on phase 12's synthetic
    SD2.1-base directory (bf16, 512², CFG 5.0, rank-4 LoRAs: two registered
    from files, one as a tree): the batch engine (grouping, padding,
    per-request determinism, exact launches a batch), `multi_lora`, the
    rolling engine (DDPM and DPM-Solver++, against the batch engine, exact
    launches a tick and a decode), `parallel_window=8` at batch 1, the HTTP
    API, and the packed sweep of 3 variants × 21 prompts with FIQA and pose
    scored on the card. Returns the phase's launch counts, the launches
    measured at SERVE_TICK_SHAPES and SERVE_DECODE_SHAPES, and what phase 17
    holds the command line to: request 0 (its prompt, seed, adapter file and
    the batch engine's image), the sweep's LoRA root and output, and the
    sweep's img/s."""
    import base64
    import io
    import os
    import urllib.request

    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.diffusion import parallel_sampler, sampler
    from faceposegenerator_tpu_torch.diffusion.lora_io import save_lora_safetensors, zero_lora
    from faceposegenerator_tpu_torch.evaluation import fiqa, pose
    from faceposegenerator_tpu_torch.models import iresnet
    from faceposegenerator_tpu_torch.pipelines import sweep
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
    from faceposegenerator_tpu_torch.serving import GenerationRequest, RollingServer, SamplerServer
    from faceposegenerator_tpu_torch.serving.http_api import start_http_background

    t_phase = time.time()
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16)
    total = {n: 0 for n in _launch_counts()}

    def add(records):
        for r in records:
            for n, c in r["launches"].items():
                total[n] += c

    # three rank-4 adapters: l1 and l2 from files, l3 as a tree
    trees = []
    for seed in (41, 42, 43):
        tree = zero_lora(pipe.nets["unet"], pipe.nets["text_encoder"], dtype=torch.bfloat16)
        tree["unet"] = make_lora(pipe.nets["unet"], seed, torch)["unet"]
        trees.append(tree)
    files = {}
    for name, tree in zip(("l1", "l2"), trees):
        files[name] = os.path.join(work, "loras", name)
        save_lora_safetensors(tree, os.path.join(files[name], "pytorch_lora_weights.safetensors"))

    def register(srv):
        for name, path in files.items():
            srv.register_lora(name, path)
        srv.register_lora("l3", trees[2])
        return srv

    def req(prompt, seed, lora):
        return GenerationRequest(prompt=PROMPTS[prompt], negative_prompt=NEGATIVE_PROMPT, seed=seed, lora_id=lora)

    served, res, steps = SERVED, SERVED["height"], SERVED["num_inference_steps"]
    # 12 requests over l1, l2 and none: 5, 4 and 3 of them, so 3 batches, each padded; request 2 differs from
    # request 0 by its seed alone, request 3 by its adapter alone
    reqs = [req(0, 100, "l1"), req(1, 101, None), req(0, 102, "l1"), req(0, 100, "l2")]
    reqs += [req(i % 8, 100 + i, lora)
             for i, lora in zip(range(4, 12), (None, "l1", "l2", "l1", None, "l2", "l1", "l2"))]
    servers = []
    try:
        # --- the batch engine -----------------------------------------------
        engine = register(SamplerServer(pipe, batch_size=8, max_wait_s=0.05, **served))
        servers.append(engine)
        with step_probe(sampler, "sample", factory=False) as batches:
            mixed = [f.result() for f in [engine.submit(r) for r in reqs]]
            alone = engine.generate([reqs[0]])[0]
        add(batches.records)
        _expect_each(batches.records, SERVE_BATCH_LAUNCHES, "batch engine batch")
        stats = engine.stats()
        print(f"batch engine: 12 requests in {len(batches.records) - 1} batches + 1 alone, "
              f"s/batch {[round(r['s'], 3) for r in batches.records]} (phase 4's request {default_secs:.3f}); "
              f"stats {json.dumps(stats)} ({card_line})", flush=True)
        if stats["batches"] != 4 or stats["padded_slots"] != 3 + 5 + 4 + 7:
            fail(f"the batch engine grouped 12 requests into {stats}, expected 3 padded batches and 1 alone")
        for r in mixed:
            _check_images(r.image[None].astype(np.float32) / 255.0, 1, res, "batch engine image")
        _u8_diff(alone.image, mixed[0].image, "request 0 alone vs in its mixed batch")
        for a, b, what in ((0, 2, "seeds"), (0, 3, "adapters")):
            if np.abs(mixed[a].image.astype(int) - mixed[b].image.astype(int)).max() < 8:
                fail(f"requests {a} and {b} differ by their {what} but their images do not")

        # --- multi_lora: one mixed batch of 8 over l1, l2, l3 -----------------
        l3 = [req(i, 200 + i, "l3") for i in range(4)]
        uniform = engine.generate(l3)
        multi = register(SamplerServer(pipe, batch_size=8, max_wait_s=0.5, multi_lora=True, **served))
        servers.append(multi)
        group = [reqs[0], reqs[3], reqs[2], reqs[6]] + l3
        with step_probe(sampler, "sample", factory=False) as mbatch:
            got = multi.generate(group)
        add(mbatch.records)
        _expect_each(mbatch.records, SERVE_BATCH_LAUNCHES, "multi_lora batch")
        if len(mbatch.records) != 1:
            fail(f"multi_lora ran {len(mbatch.records)} batches for 8 requests")
        want = [mixed[0], mixed[3], mixed[2], mixed[6]] + uniform
        for i, (g, w) in enumerate(zip(got, want)):
            _u8_diff(g.image, w.image, f"multi_lora slot {i} ({group[i].lora_id}) vs its uniform batch")
        print(f"multi_lora: 1 batch of 8 over 3 adapters in {mbatch.records[0]['s']:.3f} s ({card_line})", flush=True)
        multi.shutdown()

        # --- the rolling engine: 4 slots, 6 requests staggered ----------------
        roll = register(RollingServer(pipe, batch_size=4, max_wait_s=0.0, **served))
        servers.append(roll)
        picks = [0, 1, 3, 4, 5, 6]
        with step_probe(roll, "_tick", factory=False) as ticks, \
                step_probe(roll, "_decode1", factory=False) as decodes, shape_tally() as tally:
            t0 = time.time()
            futs = [roll.submit(reqs[i]) for i in picks[:3]]
            _wait_ticks(ticks.records, steps // 3, futs)
            futs.append(roll.submit(reqs[picks[3]]))  # into the free slot, the others a third of the way
            _wait_ticks(ticks.records, 2 * steps // 3, futs)
            futs += [roll.submit(reqs[i]) for i in picks[4:]]  # queued until the first three finish
            rolled = [f.result() for f in futs]
            roll_s = time.time() - t0
        add(ticks.records + decodes.records)
        _expect_each(ticks.records, TICK_LAUNCHES, "rolling tick")
        _expect_each(decodes.records, DECODE1_LAUNCHES, "rolling decode")
        if len(decodes.records) != 6:
            fail(f"the rolling engine decoded {len(decodes.records)} images for 6 requests")
        tick_s = [r["s"] for r in ticks.records]
        lat = [r.queue_s + r.batch_s for r in rolled]
        rstats = roll.stats()
        print(f"rolling: 6 requests through 4 slots in {len(tick_s)} ticks, {roll_s:.3f} s; s/tick median "
              f"{sorted(tick_s)[len(tick_s) // 2]:.4f} min {min(tick_s):.4f}; decode "
              f"{[round(r['s'], 4) for r in decodes.records]} s; latency per request {[round(x, 3) for x in lat]} s; "
              f"{6 / roll_s:.3f} img/s; stats {json.dumps(rstats)} ({card_line})", flush=True)
        measured = {name: tally.shapes.get((b, h, sq, skv, d), 0) for name, b, h, sq, skv, d, _ in SERVE_DECODE_SHAPES}
        measured.update({name: tally.shapes.get((b, h, sq, skv, d), 0) / max(len(tick_s), 1)
                         for name, b, h, sq, skv, d, _ in SERVE_TICK_SHAPES})
        measured["vae mid, rolling decode"] /= len(decodes.records)
        for name, b, h, sq, skv, d, want_n in SERVE_TICK_SHAPES + SERVE_DECODE_SHAPES:
            if measured[name] != want_n:
                fail(f"{name}: {measured[name]} launches at {b} × {h} × {sq} × {skv} × {d}, expected {want_n}")
        for i, r in zip(picks, rolled):
            _u8_diff(r.image, mixed[i].image, f"rolling request {i} vs the batch engine")
        roll.shutdown()

        # --- rolling DPM-Solver++ at 12 steps against the batch engine ---------
        dpm = dict(served, num_inference_steps=12, scheduler="dpm")
        droll = register(RollingServer(pipe, batch_size=4, max_wait_s=0.0, **dpm))
        dbatch = register(SamplerServer(pipe, batch_size=8, max_wait_s=0.5, multi_lora=True, **dpm))
        servers += [droll, dbatch]
        four = [reqs[i] for i in (0, 1, 3, 4)]
        with step_probe(droll, "_tick_dpm", factory=False) as dticks, \
                step_probe(droll, "_decode1", factory=False) as dd:
            t0 = time.time()
            drolled = droll.generate(four)
            droll_s = time.time() - t0
        with step_probe(sampler, "sample", factory=False) as db:
            dwant = dbatch.generate(four)
        add(dticks.records + dd.records + db.records)
        _expect_each(dticks.records, TICK_LAUNCHES, "rolling DPM tick")
        _expect_each(dd.records, DECODE1_LAUNCHES, "rolling DPM decode")
        _expect_each(db.records, {"flash_fwd_d64": 12 * 32, "flash_fwd_wide": 1}, "DPM batch")
        for i, (g, w) in enumerate(zip(drolled, dwant)):
            _u8_diff(g.image, w.image, f"rolling DPM++ 12 request {i} vs the batch engine")
        print(f"rolling DPM++ 12: 4 requests in {len(dticks.records)} ticks, {droll_s:.3f} s; batch engine "
              f"{db.records[0]['s']:.3f} s ({card_line})", flush=True)
        droll.shutdown()
        dbatch.shutdown()

        # --- parallel_window=8 at batch 1 ------------------------------------
        iters = []
        plain_parallel = parallel_sampler.sample_parallel

        def counted(*a, **kw):
            images, n = plain_parallel(*a, **dict(kw, return_stats=True))
            iters.append(n)
            return images

        one = req(2, 300, None)
        seq = SamplerServer(pipe, batch_size=1, max_wait_s=0.0, **served)
        servers.append(seq)
        with step_probe(sampler, "sample", factory=False) as sq:
            seq_img = [seq.generate([one])[0] for _ in range(2)][-1]
        add(sq.records)
        _expect_each(sq.records, SERVE_BATCH_LAUNCHES, "sequential batch-1 request")
        seq.shutdown()
        parallel_sampler.sample_parallel = counted
        try:
            for tol in (0.0, 0.1):
                par = SamplerServer(pipe, batch_size=1, max_wait_s=0.0, parallel_window=8, parallel_tolerance=tol,
                                    **served)
                servers.append(par)
                with step_probe(parallel_sampler, "sample_parallel", factory=False) as pr:
                    par_img = [par.generate([one])[0] for _ in range(2)][-1]
                add(pr.records)
                for r, n in zip(pr.records, iters[-2:]):
                    if r["launches"] != {"flash_fwd_d64": 32 * n, "flash_fwd_wide": 1}:
                        fail(f"parallel_window=8 at tolerance {tol}: {r['launches']} for {n} Picard iterations")
                print(f"parallel_window=8, tolerance {tol}: n_iters {iters[-2:]}, s/request "
                      f"{[round(r['s'], 3) for r in pr.records]} against the sequential batch-1 request "
                      f"{[round(r['s'], 3) for r in sq.records]} ({card_line})", flush=True)
                if tol == 0.0:
                    if iters[-1] != steps:
                        fail(f"tolerance 0 took {iters[-1]} Picard iterations, expected {steps}")
                    _u8_diff(par_img.image, seq_img.image, "parallel_window=8 tolerance 0 vs the sequential server")
                else:
                    d = np.abs(par_img.image.astype(int) - seq_img.image.astype(int))
                    print(f"parallel_window=8 tolerance 0.1 vs sequential: uint8 max diff {int(d.max())}, "
                          f"mean {d.mean():.3f}", flush=True)
                par.shutdown()
        finally:
            parallel_sampler.sample_parallel = plain_parallel

        # --- the HTTP API on the batch engine ----------------------------------
        httpd, port = start_http_background(engine, host="127.0.0.1", port=0)
        try:
            body = json.dumps({"prompt": reqs[0].prompt, "negative_prompt": NEGATIVE_PROMPT, "seed": 100,
                               "lora_id": "l1"}).encode()
            t0 = time.time()
            with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                                               method="POST"), timeout=300) as r:
                status, out = r.status, json.load(r)
            http_s = time.time() - t0
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
                http_stats = json.load(r)
        finally:
            httpd.shutdown()
            httpd.server_close()
        img = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))))
        print(f"http: POST /generate {status} in {http_s:.3f} s, /stats {json.dumps(http_stats)}", flush=True)
        if status != 200 or img.shape != (res, res, 3):
            fail(f"POST /generate answered {status} with an image of {img.shape}")
        _u8_diff(img, mixed[0].image, "the HTTP request's PNG vs request 0 in its mixed batch")
        engine.shutdown()

        # --- the packed sweep: 3 variants × 21 prompts, FIQA and pose on the card --
        lora_root, out_root = os.path.join(work, "sweep_loras"), os.path.join(work, "sweep")
        for variant, tree in zip(sweep.MODEL_VARIANTS, trees):
            save_lora_safetensors(tree, os.path.join(lora_root, variant, "id_7", "checkpoint-31-6400",
                                                     "pytorch_lora_weights.safetensors"))
        arcface = iresnet.IResNet(iresnet.config_for("r100"), seed=5)
        quality_u8 = fiqa.make_quality_fn_u8(arcface, fiqa.init_qs_head(seed=6))
        pose_u8 = pose.make_pose_fn_u8(pose.init_sixdrepnet(seed=7))
        scored, latents = [], {}
        plain_noise = sampler.per_prompt_noise

        def recorded_noise(identity, prompt_idx, *a, **kw):
            noise = plain_noise(identity, prompt_idx, *a, **kw)
            for b, p in enumerate(prompt_idx):
                latents.setdefault(int(p), []).append(noise[0, b].clone())
            return noise

        def hook(model, identity, names, images):
            scored.append((names, quality_u8(images)[1], pose_u8(images)))

        sampler.per_prompt_noise = recorded_noise
        try:
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            sweep.run_sweep(pipe, lora_root, out_root, identities=["id_7"], pack_variants=True, batch_size=8,
                            on_images=hook, **served)
            torch.cuda.synchronize()
            sweep_s = time.time() - t0
        finally:
            sampler.per_prompt_noise = plain_noise
        launches = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
        add([{"launches": launches}])
        if launches != SWEEP_LAUNCHES:
            fail(f"the packed sweep launched {launches}, expected {SWEEP_LAUNCHES}")
        pngs = [f for v in sweep.MODEL_VARIANTS for f in os.listdir(os.path.join(out_root, v, "id_7"))]
        grid = os.path.join(out_root, "comparison_grids", "id_7.png")
        if len(pngs) != 63 or not os.path.exists(grid):
            fail(f"the packed sweep wrote {len(pngs)} images (expected 63), grid {os.path.exists(grid)}")
        if len(scored) != 8 or [n is None for n in scored[-1][0]] != [False] * 7 + [True]:
            fail(f"the sweep's hook saw {len(scored)} batches, the last one's names "
                 f"{scored[-1][0] if scored else None}")
        for p, views in latents.items():
            if not all(torch.equal(v, views[0]) for v in views[1:]):
                fail(f"prompt {p}: the variants' initial latents differ")
        if sorted(latents) != list(range(21)) or min(len(v) for v in latents.values()) < 3:
            fail(f"initial latents recorded for prompts {sorted(latents)}")
        q = torch.cat([s[1] for s in scored]).float().cpu().numpy()
        angles = torch.cat([s[2] for s in scored]).float().cpu().numpy()
        if not (np.isfinite(q).all() and np.isfinite(angles).all() and q.shape == (64,) and angles.shape == (64, 3)):
            fail("FIQA or pose scores are not finite")
        batch = torch.from_numpy(np.stack([np.asarray(Image.open(os.path.join(out_root, sweep.MODEL_VARIANTS[0], "id_7",
                                                                              f"id_7_{i:03d}.png")))
                                           for i in range(8)])).to(pipe.device)
        rates = {}
        for name, fn in (("fiqa", quality_u8), ("pose", pose_u8)):
            fn(batch)
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(5):
                fn(batch)
            torch.cuda.synchronize()
            rates[name] = 40 / (time.time() - t0)
        print(f"packed sweep: 3 variants × 21 prompts, 8 batches of 8 (1 pad slot), 512², 30 steps: {sweep_s:.3f} "
              f"s/identity, {63 / sweep_s:.3f} img/s; launches {json.dumps(launches)}; FIQA r100 "
              f"{rates['fiqa']:.1f} img/s, pose RepVGG-B1g2 {rates['pose']:.1f} img/s (8 × 512² uint8 a call); "
              f"quality {q.min():.4f}..{q.max():.4f}, yaw {angles[:, 1].min():.2f}..{angles[:, 1].max():.2f} "
              f"({card_line})", flush=True)
    finally:
        for srv in servers:
            srv.shutdown()
    del pipe
    torch.cuda.empty_cache()
    print(f"serving: phase 14 in {time.time() - t_phase:.1f} s ({card_line})", flush=True)
    refs = {"request": reqs[0], "lora_file": files["l1"], "image": mixed[0].image, "lora_root": lora_root,
            "sweep": out_root, "sweep_img_s": 63 / sweep_s}
    return {n: c for n, c in total.items() if c}, measured, refs


# Phase 15: the identity stack and FR training. No TPU kernel lies on this
# path (the JAX package leaves BatchNorm, the IResNet/MobileFaceNet/MTCNN
# convolutions, the margin heads and the face ViT's einsum attention to XLA),
# so the phase launches none of K1-K8.
FR_GATE = dict(batch=8, res=112, classes=16, depths=(1, 1, 1, 1), steps=2)
FR_BENCH = dict(network="iresnet50", batch=128, res=112, classes=1000, steps=10)
FR_DRIVER = dict(identities=1000, per_identity=2, pairs=600, epochs=2, max_steps=4)
EMBED_BENCH = dict(folders=16, per_folder=32, black=8, res=250, batch=64)
BF16_MAX, BF16_MEAN = 2e-2, 2e-3


def _rel_err(got, want):
    """(max abs err, mean abs err) over the max abs of `want`, in fp64."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want)
    return float(d.max()) / scale, float(d.mean()) / scale


def _textured_face(rng, res, size):
    """A res² uint8 image as the JAX embed bench draws it (bench.py:431-435:
    noise in [10, 60), a bright square of `size`), its square textured: 4×4
    blocks of random codes in [246, 255]. The bright-square cascade finds
    it, and its P-Net cells score apart by more than rounding; on a flat
    square many cells score the same, NMS chooses among them by rounding,
    and the card and the CPU keep different boxes of equal score."""
    import numpy as np

    img = rng.integers(10, 60, (res, res, 3)).astype(np.uint8)
    y0, x0 = rng.integers(10, res - size - 10, 2)
    blocks = rng.integers(246, 256, (-(-size // 4), -(-size // 4), 3)).astype(np.uint8)
    img[y0 : y0 + size, x0 : x0 + size] = np.repeat(np.repeat(blocks, 4, 0), 4, 1)[:size, :size]
    return img


def _fr_pair(torch, fr, cfg, bcfg):
    """The same initial FR state on the CPU and on the card (built on the CPU
    from seed 0 and copied: the two devices' generators draw differently)."""
    cpu = fr.init_train_state(cfg, 0, "cpu", bcfg)
    card = fr.init_train_state(cfg, 0, "cuda", bcfg)
    card[0]["backbone"].load_state_dict(cpu[0]["backbone"].state_dict())
    with torch.no_grad():
        card[0]["kernel"].copy_(cpu[0]["kernel"])
    return cpu, card


def _fr_gate(torch, fr, card_line, heads=("AdaFace", "ArcFace", "CosFace", "ElasticCosFace"), in_channels=3):
    """Each head, 2 steps of the tiny backbone at 112² on `in_channels`
    channels (4: RGBN), fp32 with TF32 off, the card against the port on the
    CPU from the same weights and draws."""
    import numpy as np

    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.core.tree import tree_paths

    n, res, classes = FR_GATE["batch"], FR_GATE["res"], FR_GATE["classes"]
    g = torch.Generator().manual_seed(11)
    batch = {"images": torch.rand(n, res, res, in_channels, generator=g) * 2 - 1,
             "labels": torch.randint(0, classes, (n,), generator=g)}
    out = {}
    with tf32(False):
        for head in heads:
            cfg = fr.FRConfig(loss=head, batch_size=n, num_classes=classes)
            bcfg = fr.backbone_config(cfg, depths=FR_GATE["depths"], in_channels=in_channels)
            (cp, cs), (gp, gs) = _fr_pair(torch, fr, cfg, bcfg)
            runs = []
            for params, state in ((cp, cs), (gp, gs)):
                opt = fr.make_optimizer(cfg)
                opt_state, step = opt.init(params), fr.make_train_step(cfg, opt, PARITY_POLICY)
                losses = []
                for i in range(FR_GATE["steps"]):
                    gi = torch.Generator().manual_seed(100 + i)
                    draws = {"dropout": torch.rand(n, 512 * 49, generator=gi) < 1 - cfg.dropout,
                             "margin": torch.randn(n, generator=gi)}
                    params, state, opt_state, m = step(params, state, opt_state, batch, draws=draws)
                    losses.append(float(m["loss"]))
                runs.append((losses, fr.fr_checkpoint_tree(params, state)))
            (cpu_losses, cpu_tree), (card_losses, card_tree) = runs
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
            errs = {}
            for part in ("params", "state"):
                want = dict(tree_paths(cpu_tree[part]))
                scale = max(float(np.abs(v).max()) for v in want.values())
                errs[part] = max(float(np.abs(v - want[p]).max()) for p, v in tree_paths(card_tree[part])) / scale
            print(f"fr gate {head}{' RGBN' if in_channels == 4 else ''}: loss {card_losses} (cpu {cpu_losses}), loss rel err {loss_err:.2e}, "
                  f"params err {errs['params']:.2e}, state err {errs['state']:.2e} of the max abs", flush=True)
            if not (loss_err <= 1e-4 and errs["params"] <= 1e-4 and errs["state"] <= 1e-5):
                fail(f"FR gate {head}: loss {loss_err:.2e} (1e-4), params {errs['params']:.2e} (1e-4), "
                     f"state {errs['state']:.2e} (1e-5)")
            out[head] = {"loss_rel_err": loss_err, **errs}
    return out


def _fr_bench(torch, fr, card_line, in_channels=3, others=True):
    """iresnet50 + AdaFace at the bench op point (batch 128, 112², 1000
    classes, fp32 params, bf16 compute): 10 steps on one batch on the card;
    then, with `others`, one step of each other head and of the SE
    variant. Phase 20 runs it at in_channels=4."""
    import statistics

    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY
    from faceposegenerator_tpu_torch.core.rng import train_step_generator

    n, res = FR_BENCH["batch"], FR_BENCH["res"]
    g = torch.Generator(device="cuda").manual_seed(12)
    batch = {"images": torch.rand(n, res, res, in_channels, generator=g, device="cuda") * 2 - 1,
             "labels": torch.randint(0, FR_BENCH["classes"], (n,), generator=g, device="cuda")}

    def one_run(head, steps, **bkw):
        cfg = fr.FRConfig(network=FR_BENCH["network"], loss=head, batch_size=n, num_classes=FR_BENCH["classes"])
        params, state = fr.init_train_state(cfg, 0, "cuda", fr.backbone_config(cfg, **bkw))
        before = {k: v.clone() for k, v in params["backbone"].bn1.state_dict().items() if k in ("mean", "var")}
        opt = fr.make_optimizer(cfg, steps_per_epoch=1)
        opt_state, step = opt.init(params), fr.make_train_step(cfg, opt, DEFAULT_POLICY)
        secs, losses = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.time()
            params, state, opt_state, m = step(params, state, opt_state, batch, train_step_generator(0, i, "cuda"))
            losses.append(float(m["loss"]))
            secs.append(time.time() - t0)
        moved = all(not torch.equal(before[k], getattr(params["backbone"].bn1, k)) for k in before)
        if not (all(math.isfinite(v) for v in losses) and moved):
            fail(f"FR bench {head} {bkw}: losses {losses}, BN statistics moved {moved}")
        return secs, losses

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = one_run("AdaFace", FR_BENCH["steps"], in_channels=in_channels)
    steady = statistics.median(secs[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"fr bench: iresnet50 AdaFace, in_channels={in_channels}, batch {n}, {res}², {FR_BENCH['classes']} "
          f"classes, fp32 params, bf16 "
          f"compute: {steady:.4f} s/step (median of steps 2-{len(secs)}; first {secs[0]:.2f} s), "
          f"{n / steady:.1f} train img/s, peak memory {peak:.2f} GiB, losses {losses[0]:.3f} → {losses[-1]:.3f} "
          f"({card_line})", flush=True)
    if others:
        losses = {}
        for head, kw in (("ArcFace", {}), ("CosFace", {}), ("ElasticCosFace", {}), ("AdaFace", {"use_se": True})):
            s, l_ = one_run(head, 1, **kw)
            losses[head + (" SE" if kw else "")] = l_[0]
        print(f"fr bench: one step each, loss {json.dumps(losses)}", flush=True)
    return {"s_per_step": steady, "img_per_s": n / steady, "peak_gib": peak}


def _write_fr_data(root, torch):
    """1000 identities × 2 JPEGs of 112² (flat `<label>_<i>.jpg`) and a
    600-pair verification .bin in the reference's pickle layout."""
    import io
    import os
    import pickle

    import numpy as np
    from PIL import Image

    flat = os.path.join(root, "flat")
    os.makedirs(flat, exist_ok=True)
    rng = np.random.default_rng(13)
    base = rng.integers(30, 225, (FR_DRIVER["identities"], 1, 1, 3))
    for i in range(FR_DRIVER["identities"]):
        for j in range(FR_DRIVER["per_identity"]):
            img = np.clip(base[i] + rng.normal(0, 25, (112, 112, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(flat, f"{i}_{j}.jpg"), quality=90)
    bins, issame = [], []
    for p in range(FR_DRIVER["pairs"]):
        same = p % 2 == 0
        a = np.clip(rng.integers(30, 225, (1, 1, 3)) + rng.normal(0, 25, (112, 112, 3)), 0, 255).astype(np.uint8)
        b = np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.uint8) if same else \
            np.clip(rng.integers(30, 225, (1, 1, 3)) + rng.normal(0, 25, (112, 112, 3)), 0, 255).astype(np.uint8)
        for img in (a, b):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            bins.append(buf.getvalue())
        issame.append(same)
    path = os.path.join(root, "lfw.bin")
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return flat, path


def _fr_driver(torch, fr, card_line, root):
    """train_fr_run at the bench op point on 2000 JPEGs (2 epochs of at most 4
    steps, verification each epoch), then test_fr_run on its best file."""
    from faceposegenerator_tpu_torch.data.fr_dataset import FlatDirDataset
    from faceposegenerator_tpu_torch.evaluation import verification

    t0 = time.time()
    flat, bin_path = _write_fr_data(root, torch)
    bins = {"lfw": verification.load_bin(bin_path)}
    t_data = time.time() - t0
    out = _fr_run(torch, fr, card_line, FlatDirDataset(flat), bins, root, "fr driver")
    print(f"fr driver: data written in {t_data:.1f} s", flush=True)
    return out


def _fr_run(torch, fr, card_line, dataset, bins, root, label):
    """train_fr_run of iresnet50 + AdaFace at batch 128 on `dataset` (2
    epochs of at most 4 steps, verification on `bins` each epoch), then
    test_fr_run on its best file, which must give the best epoch's accuracy.
    Returns s/step with the batch load and the verification seconds."""
    import os
    import statistics

    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY
    from faceposegenerator_tpu_torch.training import fr_driver

    cfg = fr.FRConfig(network=FR_BENCH["network"], loss="AdaFace", batch_size=FR_BENCH["batch"],
                      num_epochs=FR_DRIVER["epochs"])
    out = os.path.join(root, "run")
    with step_probe(fr, "make_train_step") as steps, step_probe(fr_driver.verification, "test", factory=False) as ver:
        res = fr_driver.train_fr_run(cfg, dataset, out, val_bins=bins, policy=DEFAULT_POLICY,
                                     max_steps_per_epoch=FR_DRIVER["max_steps"])
    ver_secs = [r["s"] for r in ver.records]
    ends = [r["end"] for r in steps.records]
    per = FR_DRIVER["max_steps"]
    # s/step with the batch load: from one step's end to the next's, within an epoch
    gaps = [b - a for e in range(FR_DRIVER["epochs"]) for a, b in zip(ends[e * per : (e + 1) * per - 1],
                                                                   ends[e * per + 1 : (e + 1) * per])]
    for name in ("best_backbone.npz", "history.json", "fr_config.json"):
        if not os.path.exists(os.path.join(out, name)):
            fail(f"{label}: train_fr_run left no {name}")
    if len(steps.records) != FR_DRIVER["epochs"] * per or len(res["history"]) != FR_DRIVER["epochs"]:
        fail(f"{label}: train_fr_run ran {len(steps.records)} steps and {len(res['history'])} epochs")
    test = fr_driver.test_fr_run(cfg.replace(num_classes=dataset.num_classes), os.path.join(out, "best_backbone.npz"),
                                 bins, os.path.join(out, "test.json"), policy=DEFAULT_POLICY)
    if test["lfw"]["accuracy"] != res["best_acc"]:
        fail(f"{label}: test_fr_run gives accuracy {test['lfw']['accuracy']} where the run's best epoch had "
             f"{res['best_acc']}")
    print(f"{label}: {len(steps.records)} steps of batch {cfg.batch_size}, {statistics.median(gaps):.4f} s/step "
          f"with the batch load (median), verification {', '.join(f'{s:.2f}' for s in ver_secs)} s an epoch "
          f"({2 * len(bins['lfw'][1])} images and their flips), history {json.dumps(res['history'])}, "
          f"test_fr_run accuracy {test['lfw']['accuracy']:.4f} = best epoch's ({card_line})", flush=True)
    return {"s_per_step_with_load": statistics.median(gaps), "verification_s": ver_secs}


def _write_embed_tree(root):
    """16 identity folders of 32 JPEGs of 250², each a textured bright square
    of 60-119 px, and 8 black JPEGs (one in each of the first 8 folders)."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(14)
    res = EMBED_BENCH["res"]
    black = []
    for f in range(EMBED_BENCH["folders"]):
        d = os.path.join(root, f"{f:02d}")
        os.makedirs(d, exist_ok=True)
        for i in range(EMBED_BENCH["per_folder"]):
            img = _textured_face(rng, res, int(rng.integers(60, 120)))
            Image.fromarray(img).save(os.path.join(d, f"{i:02d}.jpg"), quality=95)
        if f < EMBED_BENCH["black"]:
            Image.fromarray(np.zeros((res, res, 3), np.uint8)).save(os.path.join(d, "zz_black.jpg"), quality=95)
            black.append(os.path.join(f"{f:02d}", "zz_black.jpg"))
    return black


def _damp_residuals(torch, model, gain=0.1):
    """Each block's last BatchNorm weight at `gain`: a trained ResNet's
    residual branches are small beside the identity path, a random one's are
    not, and a random r100 at gain 1 turns a one-code difference in an early
    layer (bf16 rounding, an int8 code rounding the other way) into percents
    at the embedding."""
    from faceposegenerator_tpu_torch.models.iresnet import IBasicBlock

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, IBasicBlock):
                m.bn3.weight.fill_(gain)


def _embed_stack(torch, card_line, root):
    """Embedding extraction at the bench op point, the detection and
    embedding gates, the quantized embedder and the alignment sweep."""
    import copy
    import os

    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from faceposegenerator_tpu_torch.data import align, align_driver
    from faceposegenerator_tpu_torch.models import iresnet, mtcnn
    from faceposegenerator_tpu_torch.ops import quant
    from faceposegenerator_tpu_torch.pipelines import embed_extract as ee

    images = os.path.join(root, "images")
    black = _write_embed_tree(images)
    params = mtcnn.brightness_cascade_params()
    det, det_cpu = mtcnn.MTCNN(params), mtcnn.MTCNN(params, device="cpu")
    r100 = iresnet.IResNet(iresnet.config_for("r100"), dtype=torch.bfloat16, seed=5)
    _damp_residuals(torch, r100)
    crop_embed = ee.make_crop_embed_fn(r100, DEFAULT_POLICY)

    # the streaming run, its stages timed
    timers = {"detect": 0.0, "embed": 0.0}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timers[name] += time.time() - t0
            return out
        return call

    class Detector:
        detect_batch = staticmethod(timed("detect", det.detect_batch))

    out_bf16 = os.path.join(root, "embeds_bf16")
    n_files = EMBED_BENCH["folders"] * EMBED_BENCH["per_folder"] + EMBED_BENCH["black"]
    t0 = time.time()
    res = ee.extract_embeddings_streaming(images, out_bf16, timed("embed", crop_embed), Detector,
                                          batch_size=EMBED_BENCH["batch"])
    total = time.time() - t0
    batches = -(-n_files // EMBED_BENCH["batch"])
    written = sorted(os.path.join(d, f) for d in os.listdir(out_bf16) if os.path.isdir(os.path.join(out_bf16, d))
                     for f in os.listdir(os.path.join(out_bf16, d)))
    if sorted(res["files_without_faces"]) != sorted(black) or len(written) != n_files - len(black):
        fail(f"streaming extraction: {len(written)} embeddings, files without faces {res['files_without_faces']}")
    rest = total - timers["detect"] - timers["embed"]
    print(f"embed bench: {n_files} JPEGs of {EMBED_BENCH['res']}² at batch {EMBED_BENCH['batch']}, r100 bf16: "
          f"{total / batches:.3f} s/batch, {n_files / total:.1f} img/s; detect {timers['detect']:.2f} s, "
          f"crop+embed {timers['embed']:.2f} s, decode and the rest (not hidden under the card) {rest:.2f} s "
          f"of {total:.2f} s (the first batch included); files without faces: the {len(black)} black images "
          f"({card_line})", flush=True)

    # detection: 8 images, the card against the CPU, fp32 with TF32 off
    files = sorted(os.listdir(os.path.join(images, "00")))[:8]
    batch8 = np.stack([np.asarray(Image.open(os.path.join(images, "00", f)).convert("RGB"), np.float32)
                       for f in files])
    with tf32(False):
        got, want = det.detect_batch(batch8, landmarks=True), det_cpu.detect_batch(batch8, landmarks=True)
    worst = [0.0, 0.0, 0.0]
    for b in range(len(files)):
        if (got[0][b] is None) != (want[0][b] is None) or (want[0][b] is not None and
                                                           got[0][b].shape != want[0][b].shape):
            fail(f"detection of {files[b]}: the card finds {None if got[0][b] is None else len(got[0][b])} faces, "
                 f"the CPU {None if want[0][b] is None else len(want[0][b])}")
        if want[0][b] is not None:
            for k in range(3):
                worst[k] = max(worst[k], float(np.abs(got[k][b] - want[k][b]).max()))
    print(f"detection gate: 8 images, the same counts, boxes {worst[0]:.2e} px, probs {worst[1]:.2e}, landmarks "
          f"{worst[2]:.2e} px from the CPU's", flush=True)
    if worst[0] > 0.5 or worst[2] > 0.5 or worst[1] > 1e-4:
        fail(f"detection gate: boxes {worst[0]} px, landmarks {worst[2]} px (0.5), probs {worst[1]} (1e-4)")
    boxes2 = np.stack([want[0][b][0] for b in range(2)]).astype(np.float32)

    # r100 at fp32 on 2 crops, the card against the CPU
    r100_cpu = iresnet.IResNet(iresnet.config_for("r100"), device="cpu", seed=6)
    _damp_residuals(torch, r100_cpu)
    r100_f32 = iresnet.IResNet(iresnet.config_for("r100"), seed=6)
    r100_f32.load_state_dict(r100_cpu.state_dict())
    with tf32(False):
        e_card = ee.make_crop_embed_fn(r100_f32, PARITY_POLICY)(batch8[:2], boxes2).cpu().numpy()
    e_cpu = ee.make_crop_embed_fn(r100_cpu, PARITY_POLICY, device="cpu")(batch8[:2], boxes2).numpy()
    err = _rel_err(e_card, e_cpu)
    print(f"r100 fp32 gate: 2 crops, max err {err[0]:.2e} of the max abs against the CPU", flush=True)
    if err[0] > 1e-3:
        fail(f"r100 fp32 embeddings: card against CPU {err[0]:.2e} of the max abs (1e-3)")
    del r100_f32, r100_cpu

    # the per-folder path (host crops) on 4 images: the card against the CPU
    # at fp32 (TF32 off); beside the streaming path (box sampling on the
    # card) by cosine only: the two crop differently by design (JAX's own
    # test allows cosine ~0.97)
    r100_cpu = copy.deepcopy(r100).to("cpu")
    folder = {}
    for name, d, model, dev in (("card", det, r100, None), ("cpu", det_cpu, r100_cpu, "cpu")):
        src = os.path.join(root, f"one_folder_{name}", "00")
        os.makedirs(src)
        for f in files[:4]:
            os.symlink(os.path.join(images, "00", f), os.path.join(src, f))
        out = os.path.join(root, f"embeds_folder_{name}")
        with tf32(False):
            folder[name] = (ee.extract_folder_embeddings(
                os.path.dirname(src), out, ee.make_arcface_embed_fn(model, PARITY_POLICY, device=dev), detector=d,
                batch_size=32), out)
    errs, cos_stream = [], []
    for f in files[:4]:
        npy = os.path.splitext(f)[0] + ".npy"
        a, b = (np.load(os.path.join(folder[k][1], "00", npy)) for k in ("card", "cpu"))
        c = np.load(os.path.join(out_bf16, "00", npy))
        errs.append(_rel_err(a, b)[0])
        cos_stream.append(float(a @ c / (np.linalg.norm(a) * np.linalg.norm(c))))
    print(f"per-folder path: 4 embeddings (r100 at fp32), the card against the CPU: max err {max(errs):.2e} of the "
          f"max abs; cosine to the streaming path's bf16 ones {min(cos_stream):.4f}-{max(cos_stream):.4f}", flush=True)
    if folder["card"][0] != folder["cpu"][0] or max(errs) > 1e-3:
        fail(f"extract_folder_embeddings, card against CPU: {max(errs):.2e} of the max abs (1e-3), "
             f"missing {folder['card'][0]} / {folder['cpu'][0]}")
    del r100_cpu

    # w8a8: quantize, calibrate over two batches, stream again
    calib = [np.stack([align.to_arcface_input(align.bbox_crop_resize(im.astype(np.uint8), bx))
                       for im, bx in zip(batch8[4 * k : 4 * k + 4], [w[0] for w in want[0][4 * k : 4 * k + 4]])])
             for k in range(2)]
    r100_q = copy.deepcopy(r100)
    sites = quant.quantize_iresnet(r100_q)
    ee.calibrate_embed_quant(r100_q, calib, DEFAULT_POLICY)
    out_q = os.path.join(root, "embeds_w8a8")
    t0 = time.time()
    ee.extract_embeddings_streaming(images, out_q, ee.make_crop_embed_fn(r100_q, DEFAULT_POLICY), det,
                                    batch_size=EMBED_BENCH["batch"])
    q_secs = time.time() - t0
    cos = []
    for f in written:
        a, b = np.load(os.path.join(out_q, f)), np.load(os.path.join(out_bf16, f))
        cos.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    # the quantized embedder, card against CPU on 2 crops: at fp32 compute
    # (TF32 off) the two round alike and make the same int8 codes; at bf16 a
    # code that rounds the other way in one of 100 layers moves the ones after
    # it, so that one is printed, not gated
    q_cpu = copy.deepcopy(r100_q).to("cpu")
    qerr = {}
    for label, policy in (("fp32", PARITY_POLICY), ("bf16", DEFAULT_POLICY)):
        with tf32(False):
            e_q = ee.make_crop_embed_fn(r100_q, policy)(batch8[:2], boxes2).cpu().numpy()
        e_q_cpu = ee.make_crop_embed_fn(q_cpu, policy, device="cpu")(batch8[:2], boxes2).numpy()
        qerr[label] = _rel_err(e_q, e_q_cpu)
    print(f"w8a8 embedder: {len(sites)} quantized convs, static scales from 2 batches; streaming {n_files / q_secs:.1f} "
          f"img/s; cosine to the bf16 embeddings min {min(cos):.4f}, mean {np.mean(cos):.4f}; 2 crops against "
          f"the CPU at fp32 compute: max err {qerr['fp32'][0]:.2e}, mean {qerr['fp32'][1]:.2e} of the max abs "
          f"(at bf16: {qerr['bf16'][0]:.2e}, {qerr['bf16'][1]:.2e})", flush=True)
    if qerr["fp32"][0] > BF16_MAX or qerr["fp32"][1] > BF16_MEAN:
        fail(f"w8a8 r100 at fp32 compute: card against CPU {qerr['fp32'][0]:.2e} / {qerr['fp32'][1]:.2e} "
             f"({BF16_MAX} / {BF16_MEAN})")
    del r100_q, q_cpu

    # alignment: 16 images, the card's sweep against the CPU's
    sub = os.path.join(root, "align_in", "id0")
    os.makedirs(sub)
    for f in sorted(os.listdir(os.path.join(images, "01")))[:16]:
        os.symlink(os.path.join(images, "01", f), os.path.join(sub, f))
    class Recorder:  # keeps each detection's padded image and landmarks
        def __init__(self, d):
            self.d, self.seen = d, []

        def detect(self, img, landmarks=False):
            out = self.d.detect(img, landmarks=landmarks)
            self.seen.append((img, out[2]))
            return out

    recs = [Recorder(det), Recorder(det_cpu)]
    with tf32(False):
        rep = align_driver.align_images(os.path.dirname(sub), os.path.join(root, "aligned"), recs[0])
    rep_cpu = align_driver.align_images(os.path.dirname(sub), os.path.join(root, "aligned_cpu"), recs[1])
    names = sorted(os.listdir(os.path.join(root, "aligned")))
    names_cpu = sorted(os.listdir(os.path.join(root, "aligned_cpu")))
    if names != names_cpu or rep != rep_cpu or len(names) != 17:
        fail(f"align_images: {len(names)} files on the card, {len(names_cpu)} on the CPU, reports {rep} / {rep_cpu}")
    worst = 0
    for (padded, pts), (_, pts_cpu) in zip(*(r.seen for r in recs)):
        crops = [align.norm_crop(padded, np.asarray(p[0], np.float32)) for p in (pts, pts_cpu)]
        worst = max(worst, int(np.abs(crops[0].astype(int) - crops[1].astype(int)).max()))
    print(f"alignment: 16 images, the same {len(names) - 1} files as the CPU's, crops within {worst} uint8 codes "
          f"before the JPEG encode", flush=True)
    if worst > 1:
        fail(f"aligned crops: the card's and the CPU's differ by {worst} codes (1)")
    return {"img_per_s": n_files / total, "s_per_batch": total / batches, "detect_s": timers["detect"],
            "embed_s": timers["embed"], "rest_s": rest, "w8a8_img_per_s": n_files / q_secs}


def _backbones(torch, card_line):
    """mbf, vit_t and vit_s at 112²: batch 64 in bf16 (finite, img/s), batch 2
    at fp32 with TF32 off against the port on the CPU."""
    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from faceposegenerator_tpu_torch.models import registry

    g = torch.Generator().manual_seed(15)
    x = torch.rand(64, 112, 112, 3, generator=g) * 2 - 1
    out = {}
    for name in ("mbf", "vit_t", "vit_s"):
        cpu = registry.get_model(name, device="cpu", seed=7)
        card = registry.get_model(name, seed=7)
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad(), tf32(False):
            err = _rel_err(card(x[:2].cuda(), PARITY_POLICY).cpu(), cpu(x[:2], PARITY_POLICY))
        bf16 = registry.get_model(name, dtype=torch.bfloat16, seed=7)
        xb = x.cuda()
        with torch.no_grad():
            e = bf16(xb, DEFAULT_POLICY)
            ms = time_ms(lambda: bf16(xb, DEFAULT_POLICY), torch)
        finite = bool(torch.isfinite(e).all())
        print(f"backbone {name}: batch 64 bf16 {64 / ms * 1e3:.1f} img/s ({ms:.2f} ms), finite {finite}; "
              f"fp32 batch 2 against the CPU: {err[0]:.2e} of the max abs ({card_line})", flush=True)
        if not finite or err[0] > 1e-4:
            fail(f"backbone {name}: finite {finite}, fp32 err {err[0]:.2e} (1e-4)")
        out[name] = 64 / ms * 1e3
        del cpu, card, bf16
    return out


def run_identity_stack(torch, card_line, keep=None):
    """Phase 15: the FR gate, the FR bench and driver, embedding extraction
    with its gates, alignment and the face backbones. Returns the kernel
    launches it counted (none: the path runs no TPU kernel). With `keep`, a
    directory, its files stay under it (`cli_inputs`)."""
    from faceposegenerator_tpu_torch.training import fr

    t_phase = time.time()
    _reset_launch_counts()
    gate = _fr_gate(torch, fr, card_line)
    torch.cuda.empty_cache()
    bench = _fr_bench(torch, fr, card_line)
    READINGS["fr_bench_s_per_step"] = bench["s_per_step"]
    torch.cuda.empty_cache()
    with build_dir("fr_driver", keep) as root:
        driver = _fr_driver(torch, fr, card_line, root)
    READINGS["fr_folder_s_per_step"] = driver["s_per_step_with_load"]
    torch.cuda.empty_cache()
    with build_dir("embed_extract", keep) as root:
        embed = _embed_stack(torch, card_line, root)
    torch.cuda.empty_cache()
    backbones = _backbones(torch, card_line)
    launches = {k: v for k, v in _launch_counts().items() if v}
    if launches:
        fail(f"phase 15 launched {launches}: its path runs no TPU kernel")
    print(f"identity stack: phase 15 in {time.time() - t_phase:.1f} s, no kernel launched "
          f"({card_line}); summary {json.dumps({'fr_gate': gate, 'fr_bench': bench, 'fr_driver': driver, 'embed': embed, 'backbones_img_per_s': backbones})}",
          flush=True)
    return launches


# Phase 16: the dgm-eval op point (`main_DGM_EVAL.ipynb`'s DINOv2 ViT-L/14 at
# 224², batch 64) on 512 real, 512 generated and 256 held-out 512² PNGs in 16
# folders each, the other ten encoders on the generated set, and PyEER on the
# r100 embeddings. K1 runs every ViT attention: one launch a layer a batch;
# a GradCAM probe runs the 23 layers before its tap on K1 and the tapped one
# on K1 with the log-sum-exp and one K5 pair; make_heatmap_fn takes every
# layer through K1 with the log-sum-exp and K5.
QUALITY = dict(folders=16, real=32, gen=32, test=16, res=512, batch=64, heatmaps=4, heat_batch=4)
QUALITY_METRICS = ["fd", "fd_infinity", "kd", "prdc", "realism", "vendi", "authpct", "sw", "ct", "fls"]
QUALITY_SHAPES = [("dinov2 L/14 224²", 64, 16, 257, 257, 64, 24), ("mae L/16 224²", 64, 16, 197, 197, 64, 24),
                  ("clip B/32 224²", 64, 12, 50, 50, 64, 12)]
GRADCAM_SHAPES = [("gradcam dinov2 L/14, before the tap", 1, 16, 257, 257, 64, 23)]
GRADCAM_LSE_SHAPES = [("gradcam dinov2 L/14, the tapped layer", 1, 16, 257, 257, 64, 1)]
HEATMAP_SHAPES = [("heatmap dinov2 L/14, batch 4", 4, 16, 257, 257, 64, 24)]
# every registered encoder: (its feature width, the QUALITY_SHAPES row of its
# attention, or None where it runs no K1-K8)
ENCODERS = {"dinov2": (1024, "dinov2 L/14 224²"), "pixel": (3072, None), "arcface": (512, None),
            "inception": (2048, None), "sinception": (2048, None), "clip": (768, "clip B/32 224²"),
            "swav": (2048, None), "simclr": (2048, None), "mae": (1024, "mae L/16 224²"),
            "convnext": (1536, None), "data2vec": (1024, None)}
ENCODER_F32_MAX = 1e-3  # card fp32 (TF32 off) against the CPU port, of the features' max abs
PYEER_GATE = dict(folders=8, per=4)  # r100 fp32 card vs CPU: 4 images of 8 folders of each set
PYEER_FDR_REL = 1e-3
FRESH_PROCESS_TF32 = (False, True)  # torch's defaults: cuBLAS matmuls fp32, cuDNN convolutions TF32


def _shape_key(b, h, sq, skv, d, lse=False):
    return f"{b}×{h}×{sq}×{skv}×{d}" + (" +lse" if lse else "")


def _row_counts(shapes, lse=False):
    """{shape key: launches} of rows (label, B, H, Sq, Skv, D, per run)."""
    return {_shape_key(*s[1:6], lse=lse): s[6] for s in shapes}


def _encoder_expect(name):
    """The launches a batch of 64 makes through encoder `name`: its
    attention's K1 launches and their shape, or nothing."""
    label = ENCODERS[name][1]
    if label is None:
        return {}
    row = next(s for s in QUALITY_SHAPES if s[0] == label)
    return {"flash_fwd_d64": row[6], **_row_counts([row])}


# a GradCAM probe and a make_heatmap_fn call: the kernels' counts, K1's
# launches with the log-sum-exp (the wrapper's own count) and both by shape
GRADCAM_LAUNCHES = {"flash_fwd_d64": 24, "flash_fwd_d64 +lse": 1, "flash_bwd_d64_dkv": 1, "flash_bwd_d64_dq": 1,
                    **_row_counts(GRADCAM_SHAPES), **_row_counts(GRADCAM_LSE_SHAPES, lse=True)}
HEATMAP_LAUNCHES = {"flash_fwd_d64": 24, "flash_fwd_d64 +lse": 24, "flash_bwd_d64_dkv": 24, "flash_bwd_d64_dq": 24,
                    **_row_counts(HEATMAP_SHAPES, lse=True)}


def check_quality_kernels(torch, fa, card):
    """K1 and K5 at phase 16's shapes against their plain versions, timed
    beside SDPA and the bound: (forward rows, backward rows)."""
    fwd = check_kernels(torch, fa, card, QUALITY_SHAPES, per="batch")
    fwd += check_kernels(torch, fa, card, GRADCAM_SHAPES, per="gradcam_probe")
    fwd += check_kernels(torch, fa, card, GRADCAM_LSE_SHAPES, with_lse=True, per="gradcam_probe")
    fwd += check_kernels(torch, fa, card, HEATMAP_SHAPES, with_lse=True, per="heatmap_call")
    bwd = check_backward(torch, fa, card, GRADCAM_LSE_SHAPES, per="gradcam_probe")
    bwd += check_backward(torch, fa, card, HEATMAP_SHAPES, per="heatmap_call")
    return [dict(r, phase=16) for r in fwd], [dict(r, phase=16) for r in bwd]


def _write_quality_sets(root):
    """real, gen (integer file names, so the integer-aware order differs
    from the lexical one) and test: smooth random fields (8×8 noise
    bicubic-upsampled to 512²) tinted per folder, from a numpy seed; PNG
    encodes on 8 threads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    q = QUALITY
    jobs = []
    for s, (name, per) in enumerate((("real", q["real"]), ("gen", q["gen"]), ("test", q["test"]))):
        rng = np.random.default_rng(160 + s)
        for f in range(q["folders"]):
            d = os.path.join(root, name, f"id{f:02d}")
            os.makedirs(d, exist_ok=True)
            tint = rng.uniform(40, 215, 3)
            for i in range(per):
                low = np.clip(tint + rng.normal(0, 40, (8, 8, 3)), 0, 255).astype(np.uint8)
                fname = f"{(i * 7) % per + 1}.png" if name == "gen" else f"img{i:03d}.png"
                jobs.append((low, os.path.join(d, fname)))

    def write(job):
        low, path = job
        Image.fromarray(low).resize((q["res"], q["res"]), Image.BICUBIC).save(path, compress_level=1)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    return {name: os.path.join(root, name) for name in ("real", "gen", "test")}


def _quality_counts(tally):
    """Every kernel's launches so far, K1's (and K2's, fp32's) with the
    log-sum-exp, and the attention forwards `tally` saw by shape."""
    from faceposegenerator_tpu_torch.ops import flash_attention as fa

    counts = {**_launch_counts(), **{f"{n} +lse": c for n, c in fa.LSE_LAUNCHES.items()}}
    counts.update({_shape_key(*k): c for k, c in tally.shapes.items()})
    counts.update({_shape_key(*k, lse=True): c for k, c in tally.lse.items()})
    return counts


def _delta(before, after):
    return {k: c - before.get(k, 0) for k, c in after.items() if c != before.get(k, 0)}


class timed_encoder:
    """Within the block, every encoder the registry builds for `names` has
    its host preprocessing and its device features timed per batch, with
    the launches of each batch (`_quality_counts`): `records[name]` holds
    one {"host_s", "device_s", "end", "launches", "out"} a batch (`out` the
    features it returned), `built[name]` the
    time its build ended. Each `gradcam_preprocess` call (one a GradCAM
    probe) and `mark(name)` append {"t", "counts"} to `marks[name]`."""

    def __init__(self, names, tally):
        self.names, self.tally, self.records, self.built, self.marks = names, tally, {}, {}, {}

    def __enter__(self):
        from faceposegenerator_tpu_torch.evaluation import dgm

        self.saved = dict(dgm._ENCODERS)
        for name in self.names:
            dgm._ENCODERS[name] = self._factory(name, self.saved[name])
        return self

    def mark(self, name):
        self.marks.setdefault(name, []).append({"t": time.time(), "counts": _quality_counts(self.tally)})

    def _factory(self, name, factory):
        import torch

        def build(*a, **kw):
            enc = factory(*a, **kw)
            self.built[name] = time.time()
            pre, feat, recs = enc.preprocess, enc.features, self.records.setdefault(name, [])

            def preprocess(batch):
                t0 = time.time()
                out = pre(batch)
                recs.append({"host_s": time.time() - t0})
                return out

            def features(x):
                before = _quality_counts(self.tally)
                torch.cuda.synchronize()
                t0 = time.time()
                out = feat(x)  # ends in the copy to the host
                end = time.time()
                recs[-1].update(device_s=end - t0, end=end, launches=_delta(before, _quality_counts(self.tally)),
                                out=out)
                return out

            enc.preprocess, enc.features = preprocess, features
            if enc.gradcam_preprocess is not None:
                gpre = enc.gradcam_preprocess

                def gradcam_preprocess(batch):
                    self.mark(name)
                    return gpre(batch)

                enc.gradcam_preprocess = gradcam_preprocess
            return enc

        return build

    def __exit__(self, *exc):
        from faceposegenerator_tpu_torch.evaluation import dgm

        dgm._ENCODERS.clear()
        dgm._ENCODERS.update(self.saved)


def _batches_launch(records, expect, label):
    for i, r in enumerate(records):
        if r["launches"] != expect:
            fail(f"{label}: batch {i} launched {r['launches']}, expected exactly {expect}")


def _split(records):
    """(host s, device s): their means a batch."""
    return (sum(r["host_s"] for r in records) / len(records), sum(r["device_s"] for r in records) / len(records))


def _dgm_run(torch, card_line, sets, out, tally):
    """dgm.main with dinov2 on the card, unpatched but for the encoder's
    timing: representations (per batch, 24 K1 each), all metrics, the
    GradCAM grid (each probe's window runs from its preprocess to the next
    one's, the overlay and the next PNG decode included). Then the cache
    read back bit-equal, each metric timed alone on those representations
    and equal to main's, and the PRDC, FD and KD gates. Returns (summary,
    reps, the launches of a batch and of a probe)."""
    import os

    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.evaluation import dgm

    q = QUALITY
    argv = [sets["real"], sets["gen"], "--model", "dinov2", "--metrics", *QUALITY_METRICS, "--test_path", sets["test"],
            "--heatmaps", "--heatmaps_count", str(q["heatmaps"]), "--batch_size", str(q["batch"]), "--output_dir", out]
    with timed_encoder(["dinov2"], tally) as probe:
        t0 = time.time()
        all_scores = dgm.main(argv)
        main_s = time.time() - t0
        probe.mark("dinov2")  # closes the last probe's window
    recs, marks = probe.records["dinov2"], probe.marks["dinov2"]
    n_imgs = q["folders"] * (q["real"] + q["gen"] + q["test"])
    if len(recs) != n_imgs // q["batch"]:
        fail(f"dinov2: {len(recs)} batches for {n_imgs} images at batch {q['batch']}")
    _batches_launch(recs, _encoder_expect("dinov2"), "dgm dinov2")
    probes = [{"s": b["t"] - a["t"], "launches": _delta(a["counts"], b["counts"])} for a, b in zip(marks, marks[1:])]
    if len(probes) != q["heatmaps"]:
        fail(f"GradCAM: {len(probes)} probes, expected {q['heatmaps']}")
    for i, p in enumerate(probes):
        if p["launches"] != GRADCAM_LAUNCHES:
            fail(f"GradCAM probe {i}: launched {p['launches']}, expected exactly {GRADCAM_LAUNCHES}")
    s = all_scores["gen"]
    bad = [k for k, v in s.items() if not np.all(np.isfinite(np.asarray(v, np.float64)))]
    if bad or len(s["realism"]) != q["folders"] * q["gen"]:
        fail(f"dgm scores: not finite {bad}, {len(s['realism'])} realism values")
    files = sorted(os.listdir(out))
    grid = os.path.join(out, "heatmaps_dinov2_gen_0.png")
    per_row = max(1, round(q["heatmaps"] ** 0.5))  # _write_gradcam_grid's layout
    tiles = (-(-q["heatmaps"] // per_row) * q["res"], per_row * q["res"], 3)
    if not {"aggregate.json", "scores_gen.json"} <= set(files) or sum(f.endswith(".npz") for f in files) != 3 \
            or np.asarray(Image.open(grid)).shape != tiles:
        fail(f"dgm outputs: {files}")
    # the cache read back: no encoder, no launch, bit-equal to the features
    # the batches returned (main encodes real, then test, then gen)
    before = _launch_counts()
    reps = {k: dgm.compute_representations(p, None, "dinov2", cache_dir=out) for k, p in sets.items()}
    if _launch_counts() != before:
        fail("reading the representation cache launched kernels")
    start = 0
    for k in ("real", "test", "gen"):
        n = q["folders"] * q[k] // q["batch"]
        computed = np.concatenate([r["out"] for r in recs[start:start + n]])
        labels = dgm.image_labels(dgm.list_dataset_images(sets[k]), sets[k])
        if not (np.array_equal(reps[k][0], computed) and np.array_equal(reps[k][1], labels)):
            fail(f"the .npz cache of the {k} set differs from what was computed")
        start += n
    (real, _), (gen, labels), (test, _) = reps["real"], reps["gen"], reps["test"]
    if gen.shape != (q["folders"] * q["gen"], ENCODERS["dinov2"][0]) or not np.isfinite(gen).all():
        fail(f"dinov2 features {gen.shape}")
    # each metric alone on the cached representations: its seconds, and the
    # same numbers as main's
    metric_secs, alone = {}, {}
    for m in QUALITY_METRICS:
        if m == "realism":  # per sample, computed with prdc
            continue
        t0 = time.time()
        alone.update(dgm.compute_scores([m, "realism"] if m == "prdc" else [m], real, gen, labels,
                                        reps_test=test, device="cuda"))
        metric_secs[m] = time.time() - t0
    if alone != s:
        fail("the metrics computed one at a time on the cached representations differ from dgm.main's")
    # PRDC with its distances on the card against the same call on the CPU: a
    # neighbour exactly at the k-th radius may flip by rounding, within 2/N
    from faceposegenerator_tpu_torch.evaluation.metrics import frechet_distance, kernel_distance, prdc

    card, cpu = prdc(real, gen, device="cuda"), prdc(real, gen, device="cpu")
    prdc_err = max(abs(card[k] - cpu[k]) for k in card)
    if prdc_err > 2.0 / len(gen) or any(card[k] != s[k] for k in card):
        fail(f"PRDC card {card} against CPU {cpu} (2/N = {2.0 / len(gen):.4f}) and the run's {s}")
    if frechet_distance(real, gen) != s["fd"] or kernel_distance(real, gen, seed=0)[0] != s["kd_value"]:
        fail("FD or KD recomputed on the host differs from the run's")
    host, device = _split(recs)
    rep_s = recs[-1]["end"] - probe.built["dinov2"]  # from the built encoder to the last batch's features
    summary = dict(img_per_s=n_imgs / rep_s, host_s_per_batch=host, device_s_per_batch=device,
                   gradcam_s_per_image=sum(p["s"] for p in probes) / len(probes), metric_s=metric_secs,
                   main_s=main_s, prdc_card_cpu_max_diff=prdc_err, scores={k: v for k, v in s.items() if k != "realism"})
    print(f"quality: dgm dinov2 ViT-L/14 224² batch {q['batch']}: {n_imgs} images in {rep_s:.2f} s, "
          f"{summary['img_per_s']:.1f} img/s (PNG decode + PIL resize + card); per batch host PIL resize and "
          f"normalise {host * 1e3:.1f} ms, device (copy in, forward, copy out) {device * 1e3:.1f} ms; launches a "
          f"batch {json.dumps(recs[0]['launches'])}; the GradCAM grid {summary['gradcam_s_per_image']:.3f} s an image "
          f"(windows {[round(p['s'], 3) for p in probes]}: a probe, its overlay and the next PNG decode, the grid's "
          f"PNG write in the last), "
          f"launches a probe {json.dumps(probes[0]['launches'])}; seconds per metric alone "
          f"{json.dumps({k: round(v, 3) for k, v in metric_secs.items()})}; PRDC card vs CPU max diff "
          f"{prdc_err:.4f} (2/N {2.0 / len(gen):.4f}); main {main_s:.1f} s ({card_line})", flush=True)
    print(f"quality: dgm scores {json.dumps(summary['scores'])}", flush=True)
    return summary, {"real": real, "gen": gen, "gen_labels": labels, "test": test}, recs[0]["launches"], \
        probes[0]["launches"]


def _encoder_gate(torch, name, enc, batch_u8):
    """The encoder's features on 2 images at fp32 with TF32 off, card
    against a CPU copy of the same module (within ENCODER_F32_MAX of the
    max abs); the default (bf16 for the ViTs and r100) card features against
    that fp32 CPU reference, printed."""
    import copy

    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY

    x = enc.preprocess(batch_u8)
    if enc.model is None:  # pixel: the features are the host's resized pixels
        return None, None
    cpu = copy.deepcopy(enc.model).cpu()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want = enc.forward(cpu, xt, PARITY_POLICY)
        with tf32(False):
            got = enc.forward(enc.model, xt.cuda(), PARITY_POLICY).cpu()
    default = enc.features(x)
    del cpu
    err = _rel_err(got.numpy(), want.numpy())[0]
    default_err = _rel_err(default, want.numpy())[0]
    if not err <= ENCODER_F32_MAX:
        fail(f"encoder {name}: fp32 card against CPU {err:.2e} of the max abs ({ENCODER_F32_MAX:g})")
    return err, default_err


def _encoders(torch, card_line, sets, tally):
    """The other ten encoders on the generated set at batch 64 (arcface on
    the real set too): finite (N, D) at JAX's D, exact launches a batch,
    img/s and the host/device split. Returns (summary, the arcface
    embeddings, the encoders, each encoder's launches a batch)."""
    import numpy as np

    from faceposegenerator_tpu_torch.evaluation import dgm

    q, out, emb, encs, per_batch = QUALITY, {}, {}, {}, {}
    names = [n for n in ENCODERS if n != "dinov2"]
    n = q["folders"] * q["gen"]
    with timed_encoder(names, tally) as probe:
        for name in names:
            dim = ENCODERS[name][0]
            t0 = time.time()
            enc = encs[name] = dgm._ENCODERS[name]()
            build_s = time.time() - t0
            t0 = time.time()
            reps, labels = dgm.compute_representations(sets["gen"], enc, name, batch_size=q["batch"])
            secs = time.time() - t0
            if reps.shape != (n, dim) or not np.isfinite(reps).all():
                fail(f"encoder {name}: features {reps.shape}, expected ({n}, {dim}), finite {np.isfinite(reps).all()}")
            recs = list(probe.records[name])
            if name == "arcface":
                emb["gen"] = (reps, labels)
                emb["real"] = dgm.compute_representations(sets["real"], enc, name, batch_size=q["batch"])
            _batches_launch(probe.records[name], _encoder_expect(name), f"encoder {name}")
            per_batch[name] = recs[0]["launches"]
            host, device = _split(recs)
            out[name] = dict(img_per_s=n / secs, host_s_per_batch=host, device_s_per_batch=device, build_s=build_s)
            print(f"quality: encoder {name}: ({n}, {dim}) in {secs:.2f} s, {n / secs:.1f} img/s, per batch host "
                  f"{host * 1e3:.1f} ms, device {device * 1e3:.1f} ms, launches a batch {json.dumps(per_batch[name])}; "
                  f"built in {build_s:.1f} s ({card_line})", flush=True)
    return out, emb, encs, per_batch


def _pyeer(torch, emb, enc, sets, root):
    """PyEER on the r100 embeddings (the default, bf16) of the generated
    and real sets grouped by folder, both configurations, its reports
    written. Then the card checked through it: r100 at fp32 with TF32 off
    on the card and on a CPU copy, over PYEER_GATE images of each set, PyEER
    on each (every pair scored): EER and AUC within 1/n_genuine +
    1/n_impostor of each other (one genuine and one impostor score trading
    places), FDR within PYEER_FDR_REL of itself or of 1e-2, whichever is
    larger (a smooth function of scores that differ by the embeddings' fp32
    error; below 1e-2 the two distributions overlap all but entirely)."""
    import copy
    import os

    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.evaluation import dgm, pyeer_driver

    def by_id(reps, labels):
        return {f"id{int(k):02d}": reps[labels == k] for k in sorted(set(labels.tolist()))}

    synth, real = by_id(*emb["gen"]), by_id(*emb["real"])
    try:
        import matplotlib  # noqa: F401

        plots = "the histograms and DET/ROC curves as PNG (matplotlib imports)"
    except ImportError:
        plots = "no plots: matplotlib does not import (score arrays as .npz instead)"
    print(f"quality: pyeer writes {plots}", flush=True)
    t0 = time.time()
    got = pyeer_driver.analyse(synth, real, output_dir=os.path.join(root, "pyeer"), name="arcface")
    secs = time.time() - t0
    written = sorted(os.listdir(os.path.join(root, "pyeer")))
    if set(got) != {"AmongSynth", "SynthVsReal"} or \
            not {f"arcface_pyeer.{ext}" for ext in ("json", "csv", "html", "tex")} <= set(written):
        fail(f"pyeer: configurations {sorted(got)}, files {written}")

    g = PYEER_GATE
    side = {}
    for name in ("gen", "real"):
        paths = dgm.list_dataset_images(sets[name])
        labels = dgm.image_labels(paths, sets[name])
        pick = [i for f in range(g["folders"]) for i in np.flatnonzero(labels == f)[: g["per"]]]
        x = torch.from_numpy(enc.preprocess(np.stack([np.asarray(Image.open(paths[i]).convert("RGB"), np.uint8)
                                                      for i in pick])))
        side[name] = (x, labels[pick])
    cpu_model = copy.deepcopy(enc.model).cpu()
    runs = {}
    with torch.no_grad():
        for where, model in (("card", enc.model), ("cpu", cpu_model)):
            with tf32(False):
                feats = {k: enc.forward(model, x.to(enc.device if where == "card" else "cpu"), PARITY_POLICY)
                         .float().cpu().numpy() for k, (x, _) in side.items()}
            runs[where] = pyeer_driver.analyse(by_id(feats["gen"], side["gen"][1]), by_id(feats["real"], side["real"][1]),
                                               min_samples=g["per"], skip_among=0, skip_vs_real=0)
    del cpu_model
    f, k = g["folders"], g["per"]
    pairs = {"AmongSynth": (f * k * (k - 1) // 2, f * (f - 1) // 2 * k * k), "SynthVsReal": (f * k * k, f * (f - 1) * k * k)}
    diffs = {}
    for conf, (n_gen, n_imp) in pairs.items():
        a, b = runs["card"].get(conf), runs["cpu"].get(conf)
        if a is None or b is None:
            fail(f"pyeer gate: no {conf} result (card {sorted(runs['card'])}, CPU {sorted(runs['cpu'])})")
        tol = 1.0 / n_gen + 1.0 / n_imp
        diffs[conf] = {m: abs(a[m] - b[m]) for m in ("eer", "auc", "fdr")}
        fdr_tol = PYEER_FDR_REL * max(abs(b["fdr"]), 1e-2)
        if diffs[conf]["eer"] > tol or diffs[conf]["auc"] > tol or diffs[conf]["fdr"] > fdr_tol:
            fail(f"pyeer {conf}: r100 fp32 card {a} against CPU {b} (EER, AUC within {tol:.4f}; FDR {fdr_tol:.2e})")
    print(f"quality: pyeer on r100 embeddings ({len(synth)} identities): EER AmongSynth "
          f"{got['AmongSynth']['eer']:.4f}, SynthVsReal {got['SynthVsReal']['eer']:.4f}, in {secs:.2f} s; files "
          f"{written}; r100 fp32 on {2 * f * k} images, card vs CPU: "
          f"{json.dumps({c: {m: [runs['card'][c][m], runs['cpu'][c][m]] for m in ('eer', 'auc', 'fdr')} for c in pairs})}",
          flush=True)
    return {c: {m: got[c][m] for m in ("eer", "fdr", "auc")} for c in got}, diffs


def _heatmap_fn(torch, enc, dgm_reps, sets, tally):
    """make_heatmap_fn at batch 4 on the card through DINOv2 (every layer's
    K1 with the log-sum-exp and K5): exact launches, finite maps. Returns
    (seconds, launches)."""
    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.evaluation import dgm, heatmaps

    paths = dgm.list_dataset_images(sets["gen"])[: QUALITY["heat_batch"]]
    x = enc.preprocess(np.stack([np.asarray(Image.open(p).convert("RGB"), np.uint8) for p in paths]))
    mu, prec = heatmaps.fit_real_gaussian(dgm_reps["real"])
    fn = heatmaps.make_heatmap_fn(enc.model.cls_feature, mu, prec)
    before = _quality_counts(tally)
    torch.cuda.synchronize()
    t0 = time.time()
    scores, maps = fn(x)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = _delta(before, _quality_counts(tally))
    if launches != HEATMAP_LAUNCHES or maps.shape != (len(paths), 224, 224) or not torch.isfinite(maps).all() \
            or not torch.isfinite(scores).all():
        fail(f"make_heatmap_fn: launches {launches} (expected {HEATMAP_LAUNCHES}), maps {tuple(maps.shape)}, "
             f"finite {bool(torch.isfinite(maps).all())}")
    print(f"quality: make_heatmap_fn at batch {len(paths)}: {secs:.3f} s, launches {json.dumps(launches)}", flush=True)
    return secs, launches


def _gradcam_map(torch, enc, dgm_reps, sets):
    """One GradCAM probe on the card outside the counted run: a finite
    16 × 16 map and a finite FD change (dgm.main writes only the overlay)."""
    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.evaluation import dgm, heatmaps

    u8 = np.asarray(Image.open(dgm.list_dataset_images(sets["gen"])[0]).convert("RGB"), np.uint8)
    cam = heatmaps.GradCAM(enc.gradcam_encode, dgm_reps["real"], dgm_reps["gen"], device="cuda")
    heat, delta = cam.get_map(enc.gradcam_preprocess(u8[None]), 0)
    if heat.shape != (16, 16) or not np.isfinite(heat).all() or not np.isfinite(delta):
        fail(f"GradCAM: map {heat.shape}, finite {bool(np.isfinite(heat).all())}, FD change {delta}")


def run_quality_eval(torch, card_line, keep=None):
    """Phase 16: dgm-eval with DINOv2 on the card (all metrics, GradCAM),
    the other ten encoders, make_heatmap_fn; their launches counted; then
    the gates (each encoder fp32 card vs CPU, a GradCAM map) and PyEER. The
    main path runs at the TF32 settings a fresh process starts with,
    whatever an earlier phase set. Returns the main path's launches and
    the launches measured a run at each of check_quality_kernels' rows, by
    (kernel, shape). With `keep`, a directory, its files stay under it."""
    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.evaluation import dgm

    q = QUALITY
    t_phase = time.time()
    with build_dir("quality_eval", keep) as root, tf32(*FRESH_PROCESS_TF32):
        t0 = time.time()
        sets = _write_quality_sets(root)
        print(f"quality: wrote {q['folders'] * (q['real'] + q['gen'] + q['test'])} PNGs of {q['res']}² in "
              f"{time.time() - t0:.1f} s; TF32 cuBLAS {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
        _reset_launch_counts()
        with shape_tally() as tally:
            summary, reps, dgm_batch, dgm_probe = _dgm_run(torch, card_line, sets, f"{root}/dgm_out", tally)
            torch.cuda.empty_cache()
            encoders, emb, encs, per_batch = _encoders(torch, card_line, sets, tally)
            encs["dinov2"] = dgm._ENCODERS["dinov2"]()
            summary["heatmap_fn_s"], heat_call = _heatmap_fn(torch, encs["dinov2"], reps, sets, tally)
            counts = _quality_counts(tally)
        launches = {k: v for k, v in _launch_counts().items() if v}
        _gradcam_map(torch, encs["dinov2"], reps, sets)
        gate_u8 = np.stack([np.asarray(Image.open(p).convert("RGB"), np.uint8)
                            for p in dgm.list_dataset_images(sets["gen"])[:2]])
        for name, enc in encs.items():
            err, default_err = _encoder_gate(torch, name, enc, gate_u8)
            (summary if name == "dinov2" else encoders[name]).update(f32_err=err, default_err=default_err)
            print(f"quality: encoder {name} on 2 images: " + ("host features, no card" if err is None else
                  f"fp32 card vs CPU {err:.2e}, default dtype on the card vs fp32 CPU {default_err:.2e} of the max "
                  f"abs ({ENCODER_F32_MAX:g})"), flush=True)
        arcface = encs.pop("arcface")
        del encs
        torch.cuda.empty_cache()
        pyeer, pyeer_diffs = _pyeer(torch, emb, arcface, sets, root)
    dgm_batches = q["folders"] * (q["real"] + q["gen"] + q["test"]) // q["batch"]
    gen_batches = q["folders"] * q["gen"] // q["batch"]
    expect = {"flash_fwd_d64": 24 * dgm_batches + 24 * q["heatmaps"] + (24 + 12) * gen_batches + 24,
              "flash_bwd_d64_dkv": q["heatmaps"] + 24, "flash_bwd_d64_dq": q["heatmaps"] + 24}
    if launches != expect or counts["flash_fwd_d64 +lse"] != q["heatmaps"] + 24:
        fail(f"phase 16 launched {launches} ({counts['flash_fwd_d64 +lse']} K1 with the log-sum-exp), expected "
             f"{expect} ({q['heatmaps'] + 24})")
    measured = {}
    for label, encoder in (("dinov2 L/14 224²", "dinov2"), ("mae L/16 224²", "mae"), ("clip B/32 224²", "clip")):
        row = next(s for s in QUALITY_SHAPES if s[0] == label)
        measured[("flash_fwd_d64", label)] = (dgm_batch if encoder == "dinov2" else per_batch[encoder]).get(
            _shape_key(*row[1:6]), 0)
    measured[("flash_fwd_d64", GRADCAM_SHAPES[0][0])] = dgm_probe.get(_shape_key(*GRADCAM_SHAPES[0][1:6]), 0)
    lse_key = _shape_key(*GRADCAM_LSE_SHAPES[0][1:6], lse=True)
    measured[("flash_fwd_d64", GRADCAM_LSE_SHAPES[0][0])] = dgm_probe.get(lse_key, 0)
    measured[("flash_bwd_d64", GRADCAM_LSE_SHAPES[0][0])] = dgm_probe.get("flash_bwd_d64_dkv", 0)
    measured[("flash_fwd_d64", HEATMAP_SHAPES[0][0])] = heat_call.get(_shape_key(*HEATMAP_SHAPES[0][1:6], lse=True), 0)
    measured[("flash_bwd_d64", HEATMAP_SHAPES[0][0])] = heat_call.get("flash_bwd_d64_dkv", 0)
    print(f"quality: phase 16 in {time.time() - t_phase:.1f} s, launches {json.dumps(launches)}, K1 with the "
          f"log-sum-exp {counts['flash_fwd_d64 +lse']} ({card_line}); summary "
          f"{json.dumps({'dgm': summary, 'encoders': encoders, 'pyeer': pyeer, 'pyeer_gate': pyeer_diffs}, default=float)}",
          flush=True)
    return launches, measured


# Phase 17: the command line (`faceposegenerator_tpu_torch/cli.py`) run in
# this process through `cli.main`, so the launch counters see it; `serve`
# as a child process. generate's packed batches launch phase 4's counts
# (DDPM 30) or phase 6's (the turbo preset); train-idbooth's steps phase
# 7's; the identity and FR commands none of K1-K8; dgm-eval 24 K1 a batch.
CLI_TURBO_PROMPTS = 2  # 3 variants × 2 prompts: one packed batch of 8 with 2 pad slots
# the turbo preset calibrating on one prompt (8 steps of 2 CFG rows at 512²):
# phase 6's 160 K7 calls a UNet pass, of which the wide instance takes 85
# (K > 1280 or fewer than 2048 rows): every cross k/v projection (32), L1's
# GEGLU output (5), the rest of L2's (40) and of the mid block's (8) calls
CLI_CALIB_LAUNCHES = {"qdense": 8 * 160, "qdense_quant": 8 * 85}
# a class folder of half the config's num_class_images (200), a depth cut
# that keeps the script inside its time limit: the epoch is as long as the
# folder (100 steps of 1 + 1 rows)
CLI_CLASS_IMAGES = 100
# dgm-eval on 2 of phase 16's 16 folders of each set (64 PNGs: one batch
# each): the reference subsamples --nsample images only from a set larger
# than nsample + 2000, so the folders, not the flag, keep the run small
CLI_DGM = dict(folders=("id00", "id01"), nsample=128, batch=64)
# accel-report at one prompt, 30 DDPM steps: the exact render (30 full UNet
# passes), DeepCache-3 (10 full, 20 partial: level 0's ten attentions) and
# the flash_int8 render (every attention on K8), a VAE decode each
CLI_ACCEL_LAUNCHES = {"flash_fwd_d64": 30 * 32 + 10 * 32 + 20 * 10, "flash_fwd_wide": 3, "flash_int8": 30 * 32,
                      "flash_int8_amax": 30 * 32, "flash_int8_codes": 30 * 32}


def cli_inputs(data):
    """Where phases 15 and 16 leave the files phase 17 runs on, under `data`."""
    import os

    q = os.path.join(data, "quality_eval")
    return {"embed_images": os.path.join(data, "embed_extract", "images"),
            "fr_flat": os.path.join(data, "fr_driver", "flat"), "fr_bin": os.path.join(data, "fr_driver", "lfw.bin"),
            "quality": {n: os.path.join(q, n) for n in ("real", "gen", "test")}}


class pipeline_probe:
    """Within the block, every pipeline `StableDiffusionPipeline.from_pretrained`
    makes is kept in `pipes`, in order."""

    def __enter__(self):
        from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

        self.saved, self.pipes = StableDiffusionPipeline.from_pretrained, []

        def keep(*a, **kw):
            self.pipes.append(self.saved(*a, **kw))
            return self.pipes[-1]

        StableDiffusionPipeline.from_pretrained = keep
        return self

    def __exit__(self, *exc):
        from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

        StableDiffusionPipeline.from_pretrained = self.saved


def _run_cli(torch, argv, card_line, expect=None):
    """`cli.main(argv)` in this process, its standard output captured:
    returns (what it printed, its launches, seconds). The printed output is
    shown (cut to 400 characters); `expect`, when given, must be the
    launches."""
    import contextlib
    import io

    from faceposegenerator_tpu_torch import cli

    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {n: c - before[n] for n, c in _launch_counts().items() if c != before[n]}
    text = out.getvalue().strip()
    shown = " ".join(text.split())
    print(f"cli {argv[0]}: {secs:.2f} s, launches {json.dumps(launches)}; printed "
          f"{shown[:400]}{' …' if len(shown) > 400 else ''} ({card_line})", flush=True)
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    if expect is not None and launches != expect:
        fail(f"cli {argv[0]} launched {launches}, expected {expect}")
    return text, launches, secs


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _finite_numbers(tree, label):
    import math

    if isinstance(tree, dict):
        for k, v in tree.items():
            _finite_numbers(v, f"{label}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _finite_numbers(v, f"{label}[{i}]")
    elif tree is None:
        fail(f"{label} is null")
    elif not isinstance(tree, (str, bool)) and not math.isfinite(float(tree)):
        fail(f"{label} = {tree} is not finite")


def _png(path):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _cli_generate(torch, card_line, model_dir, refs, root):
    """generate at DDPM 30 with --pack_variants --eval: the reference's
    operating point (3 variants × 21 prompts of one identity, batch 8, 8
    batches, 1 pad slot), each PNG against phase 14's packed sweep, the eval
    files; then --preset turbo --pack_variants --eval at 2 prompts (one
    batch of 8, 2 pad slots), each variant's slots against the same prompts
    rendered unpacked, one variant a batch, on the CLI's own pipeline."""
    import os

    import numpy as np

    from faceposegenerator_tpu_torch.diffusion import sampler
    from faceposegenerator_tpu_torch.diffusion.lora_io import load_lora_safetensors
    from faceposegenerator_tpu_torch.pipelines import sweep, txt2img
    from faceposegenerator_tpu_torch.pipelines.presets import get_preset
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    total = {}
    out = os.path.join(root, "generate")
    argv = ["generate", "--model_dir", model_dir, "--lora_root", refs["lora_root"], "--output", out,
            "--pack_variants", "--eval"]
    with step_probe(txt2img, "sample", factory=False) as batches:  # the pipeline's batches
        printed, launches, secs = _run_cli(torch, argv, card_line)
    _add_counts(total, launches)
    _expect_each(batches.records, REQUEST_LAUNCHES, "cli generate batch")
    if len(batches.records) != 8:
        fail(f"cli generate ran {len(batches.records)} batches, expected 8")
    worst = (0, 0.0)
    for v in sweep.MODEL_VARIANTS:
        for p in range(21):
            name = os.path.join(v, "id_7", f"id_7_{p:03d}.png")
            got, want = _png(os.path.join(out, name)), _png(os.path.join(refs["sweep"], name))
            if not np.array_equal(got, want):
                worst = max(worst, _u8_diff(got, want, f"cli generate {name} vs phase 14's sweep"))
    rows = open(os.path.join(out, "eval", "fiqa_scores.txt")).read().splitlines()
    poses = json.load(open(os.path.join(out, "eval", "pose_stats.json")))
    scores = np.array([float(r.rsplit(" ", 1)[1]) for r in rows])
    if len(rows) != 63 or poses["global"]["count"] != 63 or not np.isfinite(scores).all():
        fail(f"cli generate --eval wrote {len(rows)} scores and {poses['global']['count']} poses, expected 63")
    if _last_json(printed) != {"eval": os.path.join(out, "eval"), "images": 63}:
        fail(f"cli generate --eval printed {printed[-200:]}")
    sample_s = sum(r["s"] for r in batches.records)
    print(f"cli generate (DDPM 30, --pack_variants --eval, 3 × 21 at batch 8): {secs:.2f} s, {63 / secs:.3f} img/s "
          f"({63 / sample_s:.3f} img/s over its 8 batches); the 63 PNGs against phase 14's sweep: "
          f"{'bit-equal' if worst == (0, 0.0) else f'uint8 max diff {worst[0]}'}; phase 14's sweep "
          f"{refs['sweep_img_s']:.3f} img/s ({card_line})", flush=True)

    # the turbo preset, packed, with the eval hooks
    out_t = os.path.join(root, "generate_turbo")
    argv = ["generate", "--model_dir", model_dir, "--lora_root", refs["lora_root"], "--output", out_t,
            "--preset", "turbo", "--pack_variants", "--eval", "--num_prompts", str(CLI_TURBO_PROMPTS)]
    with pipeline_probe() as made, step_probe(StableDiffusionPipeline, "calibrate_quant", factory=False) as calib, \
            step_probe(txt2img, "sample", factory=False) as tb:
        printed, launches, secs = _run_cli(torch, argv, card_line)
    _add_counts(total, launches)
    pipe = made.pipes[0]
    if len(calib.records) != 1 or any(calib.records[0]["launches"].get(n) != c
                                      for n, c in CLI_CALIB_LAUNCHES.items()):
        fail(f"cli generate --preset turbo calibrated {len(calib.records)} times, launching "
             f"{[r['launches'] for r in calib.records]}; expected once, with {CLI_CALIB_LAUNCHES} among them")
    _expect_each(tb.records, TURBO_LAUNCHES["auto"], "cli generate --preset turbo batch")
    if len(tb.records) != 1:
        fail(f"cli generate --preset turbo --pack_variants ran {len(tb.records)} batches, expected 1")
    n_img = len(sweep.MODEL_VARIANTS) * CLI_TURBO_PROMPTS
    if _last_json(printed) != {"eval": os.path.join(out_t, "eval"), "images": n_img}:
        fail(f"cli generate --preset turbo --eval printed {printed[-200:]}")
    preset = get_preset("turbo")
    prompts = sweep.build_prompts("id_7", {}, sweep.build_prompt_combinations(), CLI_TURBO_PROMPTS, seed=0)
    tok, neg = pipe.tokenize(prompts), pipe.tokenize([sweep.DEFAULT_NEGATIVE])
    pis = list(range(CLI_TURBO_PROMPTS))
    noise = sampler.per_prompt_noise(7, pis, preset.steps, 64, 64, pipe.device)
    packed, ref_s = {}, []
    for v in sweep.MODEL_VARIANTS:
        tree = load_lora_safetensors(os.path.join(refs["lora_root"], v, "id_7", "checkpoint-31-6400"),
                                     pipe.nets["unet"], pipe.nets["text_encoder"], dtype=pipe.policy.param_dtype)
        torch.cuda.synchronize()
        t0 = time.time()
        want = pipe(input_ids=tok, negative_input_ids=neg.expand(len(pis), -1), lora=tree, noise_override=noise,
                    num_inference_steps=preset.steps, guidance_scale=5.0, height=512, width=512,
                    **preset.sample_kwargs())
        ref_s.append(time.time() - t0)
        _check_images(want, len(pis), 512, f"turbo {v} unpacked")
        for p in pis:
            packed[v, p] = _png(os.path.join(out_t, v, "id_7", f"id_7_{p:03d}.png"))
            _route_diff(packed[v, p].astype(np.float32) / 255.0, want[p],
                        f"cli generate --preset turbo --pack_variants {v} prompt {p} vs unpacked")
    for p in pis:
        for a, b in zip(sweep.MODEL_VARIANTS, sweep.MODEL_VARIANTS[1:]):
            if np.abs(packed[a, p].astype(int) - packed[b, p].astype(int)).max() < 8:
                fail(f"turbo prompt {p}: variants {a} and {b} give the same image")
    rows = open(os.path.join(out_t, "eval", "fiqa_scores.txt")).read().splitlines()
    if len(rows) != n_img:
        fail(f"cli generate --preset turbo --eval wrote {len(rows)} scores, expected {n_img}")
    batch_s = tb.records[0]["s"]
    print(f"cli generate --preset turbo --pack_variants --eval (w8a8+vae, DPM++ 12, DeepCache-4, cfg_interval "
          f"(2, 8), 3 × {CLI_TURBO_PROMPTS} in one batch of 8): {secs:.2f} s with loading and calibration "
          f"({calib.records[0]['s']:.2f} s); the batch {batch_s:.3f} s = {n_img / batch_s:.3f} img/s "
          f"({8 / batch_s:.3f} slots/s) against phase 14's DDPM 30 packed sweep {refs['sweep_img_s']:.3f} img/s; "
          f"unpacked references {[round(s, 3) for s in ref_s]} s a variant ({card_line})", flush=True)
    del made, pipe
    torch.cuda.empty_cache()
    return total


def serve_child(argv, env, err_path, body, requests=1, timeout=300):
    """`cli serve argv` as a child process group with `env` over this
    process's environment (its ranks, if it spawns any, in the group): its
    "serving on" line, then /healthz (the startup's end), POST /generate of
    `body` `requests` times and GET /stats. Returns (line, startup_s,
    request_s, images, stats); the group is killed after, also on a
    failure."""
    import base64
    import io
    import os
    import queue
    import signal
    import socket
    import threading
    import urllib.request
    from pathlib import Path

    import numpy as np
    from PIL import Image

    repo = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "faceposegenerator_tpu_torch.cli", "serve", *argv, "--port", str(port)]
    env = dict(os.environ, **env)
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    with open(err_path, "w") as err:
        t0 = time.time()
        child = subprocess.Popen(argv, cwd=str(repo), env=env, stdout=subprocess.PIPE, stderr=err, text=True,
                                 start_new_session=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in child.stdout], daemon=True).start()
    try:
        line, deadline = "", time.time() + timeout
        while "serving on" not in line:
            if child.poll() is not None:
                fail(f"cli serve exited with {child.returncode} before serving: {open(err_path).read()[-2000:]}")
            if time.time() > deadline:
                fail(f"cli serve printed no 'serving on' line within {timeout} s")
            try:
                line = lines.get(timeout=0.5)
            except queue.Empty:
                continue
        # the line comes just before the command binds its port: wait for /healthz
        while True:
            if child.poll() is not None:
                fail(f"cli serve exited with {child.returncode} after its line: {open(err_path).read()[-2000:]}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                    if r.status == 200:
                        break
            except OSError:
                if time.time() > deadline:
                    fail(f"cli serve did not answer /healthz within {timeout} s of its start")
                time.sleep(0.05)
        startup_s = time.time() - t0
        request_s, images = [], []
        for _ in range(requests):
            t1 = time.time()
            with urllib.request.urlopen(urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                                               data=json.dumps(body).encode(), method="POST"),
                                        timeout=timeout) as r:
                status, out = r.status, json.load(r)
            request_s.append(time.time() - t1)
            if status != 200:
                fail(f"cli serve answered {status}: {out}")
            images.append(np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"])))))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.load(r)
        if child.poll() is not None:
            fail(f"cli serve exited with {child.returncode} while serving: {open(err_path).read()[-2000:]}")
    finally:
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        child.wait(timeout=60)
    return line.strip(), startup_s, request_s, images, stats


def _cli_serve(torch, card_line, model_dir, refs, root):
    """`serve --multi_lora` with phase 14's adapter l1 as "a", started as a
    child process: the "serving on" line, then /healthz (the startup's
    end), POST /generate of request 0 twice (cold, then warm; its PNG
    against the batch engine's image) and GET /stats; the child loads the
    kernels phase 2 built and builds none. The served PNG goes into
    `refs["served"]`, with the command's flags, for phase 19."""
    import os

    import numpy as np

    from faceposegenerator_tpu_torch.ops import _build

    libs = lambda: {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.iterdir()}  # noqa: E731
    before = libs()
    torch.cuda.empty_cache()
    req = refs["request"]
    argv = ["--model_dir", model_dir, "--lora", f"a={refs['lora_file']}", "--multi_lora"]
    body = {"prompt": req.prompt, "negative_prompt": req.negative_prompt, "seed": req.seed, "lora_id": "a"}
    # the first request pays the child's first launches; the second is warm
    line, startup_s, request_s, images, stats = serve_child(argv, {}, os.path.join(root, "serve.stderr"), body,
                                                            requests=2)
    print(f"cli serve (child process, --multi_lora, batch 8, 30 steps): '{line}', /healthz after "
          f"{startup_s:.2f} s; POST /generate twice in {[round(x, 3) for x in request_s]} s; /stats "
          f"{json.dumps(stats)} ({card_line})", flush=True)
    if images[0].shape != refs["image"].shape or stats["requests"] != 2 or not np.array_equal(*images):
        fail(f"cli serve answered images of {images[0].shape} (the two equal: {np.array_equal(*images)}), stats "
             f"{stats}")
    _u8_diff(images[0], refs["image"], "cli serve's PNG vs phase 14's batch engine (request 0)")
    after = libs()
    if after != before:
        fail(f"cli serve changed build/kernels: {sorted(set(after.items()) ^ set(before.items()))}")
    refs["served"] = {"argv": argv, "body": body, "png": images[0]}
    return {"startup_s": startup_s, "request_s": request_s[0], "warm_request_s": request_s[1]}


def _cli_train(torch, card_line, model_dir, root, driver_step_s):
    """train-idbooth on one identity of 2 JPEGs of 512², CLI_CLASS_IMAGES
    class images already in their folder, embeddings from `extract-embeds`,
    triplet_prior, one epoch (a step of 1 + 1 rows a class image: the
    dataset is as long as its class folder), each step launching phase 7's
    counts, the validation its own;
    the exported LoRA loaded into the CLI's pipeline."""
    import os
    import statistics

    from faceposegenerator_tpu_torch.core.tree import tree_paths
    from faceposegenerator_tpu_torch.training import idbooth, idbooth_driver

    src, class_dir, emb, out = (os.path.join(root, "idbooth", d) for d in ("src", "class", "emb", "out"))
    _write_faces(torch, os.path.join(src, "id_0"), 2, 512, 60)
    _write_faces(torch, class_dir, CLI_CLASS_IMAGES, 128, 61)
    _run_cli(torch, ["extract-embeds", "--images_root", src, "--output_root", emb], card_line, expect={})
    argv = ["train-idbooth", "--model_dir", model_dir, "--source_folder", src, "--output_folder", out,
            "--class_data_dir", class_dir, "--embeds_root", emb, "--losses", "triplet_prior",
            "--num_train_epochs", "1"]
    with pipeline_probe() as made, step_probe(idbooth, "make_train_step") as steps, \
            step_probe(idbooth_driver, "validation_images", factory=False) as val:
        _, launches, secs = _run_cli(torch, argv, card_line)
    _expect_each(steps.records, STEP_LAUNCHES, "cli train-idbooth step")
    _expect_each(val.records, VALIDATION_LAUNCHES, "cli train-idbooth validation")
    if len(steps.records) != CLI_CLASS_IMAGES or len(val.records) != 1:
        fail(f"cli train-idbooth ran {len(steps.records)} steps and {len(val.records)} validations, expected "
             f"{CLI_CLASS_IMAGES} and 1")
    run = os.path.join(out, "ID-Booth", "id_0")
    names = sorted(os.listdir(run))
    if "pytorch_lora_weights.safetensors" not in names or f"checkpoint-0-{CLI_CLASS_IMAGES}" not in names:
        fail(f"cli train-idbooth left {names}")
    pipe = made.pipes[0]
    pipe.load_lora_weights(run)
    moved = max(float(t.abs().max()) for path, t in tree_paths(pipe.lora["unet"]) if path.endswith("/b"))
    if not moved > 0:
        fail("the exported LoRA's B matrices load as zeros: training did not move them")
    step_s = [r["s"] for r in steps.records[1:]]
    print(f"cli train-idbooth (1 identity × 2 images + {CLI_CLASS_IMAGES} class images, 512², triplet_prior, r100, "
          f"1 epoch): "
          f"{secs:.2f} s; {len(steps.records)} steps, s/step median {statistics.median(step_s):.4f} min "
          f"{min(step_s):.4f} (1 + 1 rows) beside phase 13's {driver_step_s:.4f} (4 + 4 rows); validation "
          f"{val.records[0]['s']:.2f} s; the exported LoRA loads into the pipeline (B max {moved:.3e}); files "
          f"{names} ({card_line})", flush=True)
    del made, pipe
    torch.cuda.empty_cache()
    return launches, secs


def _cli_identity(torch, card_line, inputs, root, generated):
    """extract-embeds (folder and --streaming) and align-crop on phase 15's
    JPEGs, train-fr and test-fr on its FR files, fiqa and pose on the
    generate command's PNGs, dgm-eval (DINOv2) on 2 folders of each of
    phase 16's real and generated sets, pyeer and
    analyze on the extracted embeddings. Returns the seconds of each."""
    import os

    import numpy as np

    secs = {}
    emb_f, emb_s = os.path.join(root, "emb_folder"), os.path.join(root, "emb_stream")
    for label, out, extra in (("extract-embeds", emb_f, []), ("extract-embeds --streaming", emb_s, ["--streaming"])):
        printed, _, secs[label] = _run_cli(torch, ["extract-embeds", "--images_root", inputs["embed_images"],
                                                   "--output_root", out] + extra, card_line, expect={})
        if _last_json(printed) != {"missing": 0}:
            fail(f"cli {label} printed {printed}")
    files = sorted(os.path.join(d, f) for d in os.listdir(emb_f) if os.path.isdir(os.path.join(emb_f, d))
                   for f in os.listdir(os.path.join(emb_f, d)))
    a = np.stack([np.load(os.path.join(emb_f, f)) for f in files])
    b = np.stack([np.load(os.path.join(emb_s, f)) for f in files])
    n_img = sum(len(fs) for _, _, fs in os.walk(inputs["embed_images"]))
    if len(files) != n_img or not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail(f"cli extract-embeds wrote {len(files)} embeddings for {n_img} images")
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    print(f"cli extract-embeds: {len(files)} embeddings each way; folder vs streaming cosine min {cos.min():.4f} "
          f"(the host crop against the device crop, as in phase 15)", flush=True)

    align_in = os.path.join(root, "align_in", "phase15")
    os.makedirs(align_in)
    for d in ("00", "01"):
        os.symlink(os.path.join(inputs["embed_images"], d), os.path.join(align_in, d))
    printed, _, secs["align-crop"] = _run_cli(torch, ["align-crop", "--input_root", os.path.dirname(align_in),
                                                      "--output_root", os.path.join(root, "aligned")], card_line,
                                              expect={})
    if set(_last_json(printed)) != {"phase15"}:
        fail(f"cli align-crop printed {printed}")

    fr_out = os.path.join(root, "fr")
    printed, _, secs["train-fr"] = _run_cli(torch, ["train-fr", "--dataset_root", inputs["fr_flat"], "--output",
                                                    fr_out, "--num_epochs", "1", "--val_bin",
                                                    f"lfw={inputs['fr_bin']}"], card_line, expect={})
    best = _last_json(printed)["best_acc"]
    printed, _, secs["test-fr"] = _run_cli(torch, ["test-fr", "--backbone", os.path.join(fr_out, "best_backbone.npz"),
                                                   "--num_classes", "1000", "--val_bin", f"lfw={inputs['fr_bin']}",
                                                   "--output_json", os.path.join(root, "test_fr.json")], card_line,
                                           expect={})
    if _last_json(printed)["lfw"]["accuracy"] != best:
        fail(f"cli test-fr gives {printed} where train-fr's best epoch had {best}")

    variant = os.path.join(generated, "ID-Booth")
    fiqa_txt = os.path.join(root, "fiqa.txt")
    printed, _, secs["fiqa"] = _run_cli(torch, ["fiqa", "--image_dir", variant, "--output", fiqa_txt], card_line,
                                        expect={})
    if _last_json(printed) != {"scored": 21}:
        fail(f"cli fiqa printed {printed}")
    # the same random CR-FIQA (seeds 0, 1) scored the same images in memory under generate --eval
    from_files = {os.path.relpath(p, generated): float(s) for p, s in
                  (r.rsplit(" ", 1) for r in open(fiqa_txt).read().splitlines())}
    in_memory = {n: float(s) for n, s in (r.rsplit(" ", 1) for r in
                                          open(os.path.join(generated, "eval", "fiqa_scores.txt")).read().splitlines())}
    gap = max(abs(s - in_memory[n]) for n, s in from_files.items())
    print(f"cli fiqa: the 21 scores from the PNGs (PIL resize) vs generate --eval's in memory (resize on the "
          f"card): max abs diff {gap:.4e}", flush=True)
    printed, _, secs["pose"] = _run_cli(torch, ["pose", "--image_root", variant, "--output_json",
                                                os.path.join(root, "poses.json")], card_line, expect={})
    if _last_json(printed)["count"] != 21:
        fail(f"cli pose printed {printed}")

    import shutil

    sets = {}
    for name in ("real", "gen"):
        sets[name] = os.path.join(root, "dgm_sets", name)
        for d in CLI_DGM["folders"]:
            shutil.copytree(os.path.join(inputs["quality"][name], d), os.path.join(sets[name], d))
    n_batches = sum(-(-sum(len(fs) for _, _, fs in os.walk(d)) // CLI_DGM["batch"]) for d in sets.values())
    printed, launches, secs["dgm-eval"] = _run_cli(
        torch, ["dgm-eval", sets["real"], sets["gen"], "--model", "dinov2", "--nsample", str(CLI_DGM["nsample"]),
                "--batch_size", str(CLI_DGM["batch"]), "--metrics", "fd", "kd", "prdc", "--output_dir",
                os.path.join(root, "dgm")], card_line, expect={"flash_fwd_d64": 24 * n_batches})
    _finite_numbers(_last_json(printed), "cli dgm-eval")

    flat = os.path.join(root, "emb_flat")
    os.makedirs(flat)
    for f in files:
        d, name = os.path.split(f)
        os.symlink(os.path.join(emb_f, f), os.path.join(flat, f"{d}_{name}"))
    printed, _, secs["pyeer"] = _run_cli(torch, ["pyeer", "--synth_embeds_dir", flat, "--output",
                                                 os.path.join(root, "pyeer")], card_line, expect={})
    res = json.loads(printed)
    if set(res) != {"AmongSynth"}:
        fail(f"cli pyeer printed {sorted(res)}")
    _finite_numbers(res["AmongSynth"]["eer"], "cli pyeer AmongSynth eer")
    printed, _, secs["analyze"] = _run_cli(torch, ["analyze", "--embeds_dir", emb_f, "--output",
                                                   os.path.join(root, "analyze")], card_line, expect={})
    dist = json.loads(printed)["distribution"]
    if dist["n_identities"] != EMBED_BENCH["folders"] or not os.path.exists(os.path.join(root, "analyze",
                                                                                          "dataset_stats.json")):
        fail(f"cli analyze found {dist['n_identities']} identities")
    return launches, secs


def _add_counts(total, launches):
    for n, c in launches.items():
        total[n] = total.get(n, 0) + c


def run_cli(torch, card_line, model_dir, refs, inputs, driver_step_s):
    """Phase 17: the command line in this process (`cli.main`): generate at
    DDPM 30 and at the turbo preset, packed with --eval; serve as a child
    process; train-idbooth; accel-report; the identity, FR and evaluation
    commands; each with its launch counts and gates. `refs` are phase 14's
    (`run_serving`), `inputs` phases 15 and 16's files (`cli_inputs`).
    Returns the phase's launch counts."""
    import os

    t_phase = time.time()
    total = {}
    with build_dir("cli") as root:
        _add_counts(total, _cli_generate(torch, card_line, model_dir, refs, root))
        serve = _cli_serve(torch, card_line, model_dir, refs, root)
        launches, train_s = _cli_train(torch, card_line, model_dir, root, driver_step_s)
        _add_counts(total, launches)
        printed, launches, accel_s = _run_cli(
            torch, ["accel-report", "--model_dir", model_dir, "--mode", "deepcache=3", "--mode", "attn=flash_int8",
                    "--prompt", PROMPTS[0], "--output", os.path.join(root, "accel.json")], card_line,
            expect=CLI_ACCEL_LAUNCHES)
        _add_counts(total, launches)
        report = json.loads(printed)
        if sorted(report["modes"]) != ["attn=flash_int8", "deepcache=3"]:
            fail(f"cli accel-report reported {sorted(report['modes'])}")
        _finite_numbers(report["modes"], "cli accel-report")
        print(f"cli accel-report: PSNR deepcache=3 {report['modes']['deepcache=3']['psnr_mean']} dB, attn=flash_int8 "
              f"{report['modes']['attn=flash_int8']['psnr_mean']} dB; s {report['exact']['batch_s']} exact, "
              f"{report['modes']['deepcache=3']['batch_s']}, {report['modes']['attn=flash_int8']['batch_s']} "
              f"({card_line})", flush=True)
        launches, secs = _cli_identity(torch, card_line, inputs, root, os.path.join(root, "generate"))
        _add_counts(total, launches)
    secs.update({"serve startup": serve["startup_s"], "serve request": serve["request_s"],
                 "serve warm request": serve["warm_request_s"], "train-idbooth": train_s,
                 "accel-report": accel_s})
    print(f"cli: phase 17 in {time.time() - t_phase:.1f} s; seconds a command {json.dumps(secs)}; launches "
          f"{json.dumps(total)} ({card_line})", flush=True)
    return total


# Phase 18: distribution. The gloo rig's two ranks share the card; the TP
# request runs fewer steps than the DP one (its two reductions a
# transformer block cross the host through gloo)
DIST_WORLD, DIST_TP_STEPS, DIST_TIMEOUT_S = 2, 10, 420.0
DIST_RANK1_STEP = {"flash_fwd_d64": 32, "flash_fwd_wide": 1, "flash_bwd_d64_dkv": 32, "flash_bwd_d64_dq": 32}
# K1 at the tensor-parallel request's per-rank shapes (model 2): level 0's 5
# heads do not split and stay whole (the SHAPES rows); levels 1, 2 and the
# mid block keep half their heads on each rank; launches per TP request
TP_SHAPES = [
    ("tp self L1, 5 of 10 heads", 16, 5, 1024, 1024, 64, 5 * DIST_TP_STEPS),
    ("tp self L2, 10 of 20 heads", 16, 10, 256, 256, 64, 5 * DIST_TP_STEPS),
    ("tp self mid, 10 of 20 heads", 16, 10, 64, 64, 64, DIST_TP_STEPS),
    ("tp cross L1, 5 of 10 heads", 16, 5, 1024, 77, 64, 5 * DIST_TP_STEPS),
    ("tp cross L2, 10 of 20 heads", 16, 10, 256, 77, 64, 5 * DIST_TP_STEPS),
    ("tp cross mid, 10 of 20 heads", 16, 10, 64, 77, 64, DIST_TP_STEPS),
]
# K1, K5 and K6 at a rank's data-parallel train step: 4 of the 8 rows (the
# VAE decode of rank 0's 4 instance rows is TRAIN_SHAPES' own); launches
# per step on each rank
DIST_TRAIN_SHAPES = [(f"dp rank {label}", 4, h, sq, skv, d, n)
                     for label, _, h, sq, skv, d, n in TRAIN_SHAPES if label != "vae decode mid"]


def _leg(torch, report, name, fn):
    """Run fn() as one leg of a rank: its launches, seconds and peak memory
    into report[name]; returns fn()'s value."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    report[name] = {"s": time.time() - t0, "launches": {n: c for n, c in _launch_counts().items() if c},
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return out


def _lora_digest(torch, trainable):
    import hashlib

    from faceposegenerator_tpu_torch.core.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(trainable):
        h.update(leaf.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dist_rank(rank: int, world: int, port: int, model_dir: str, work: str, train_seeds: int = 1) -> int:
    """One rank of phase 18's gloo rig (`python3 chip_smoke.py --dist-rank
    RANK WORLD PORT MODEL_DIR WORK [TRAIN_SEEDS]`): the ranks share cuda:0
    over gloo. It writes its report to WORK/rank{RANK}.json; rank 0 also
    runs the one-process references and the gates against them. The train
    leg runs once for each of `train_seeds` LoRA inits and draws."""
    import os

    import torch

    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.core.mesh import make_mesh, rows_of
    from faceposegenerator_tpu_torch.core.rng import sampler_generator, train_step_generator
    from faceposegenerator_tpu_torch.core.tree import tree_map
    from faceposegenerator_tpu_torch.diffusion.sampler import sample, sample_2d_parallel, sample_data_parallel
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv
    from faceposegenerator_tpu_torch.parallel.pod_rehearsal import run_worker
    from faceposegenerator_tpu_torch.parallel.tp import shard_unet_params_tp
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
    from faceposegenerator_tpu_torch.training import idbooth

    fused_gn._GN_IMPL = fused_gn_conv._IMPL = "xla"
    t_rank = time.time()
    dist.init_distributed(f"127.0.0.1:{port}", world, rank, platform="cuda", backend="gloo",
                          timeout_s=DIST_TIMEOUT_S)
    dp, tp = make_mesh(data=world), make_mesh(data=1, model=world)
    dev = dp.device
    report = {"rank": rank, "device": str(dev)}
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16)
    nets = pipe.nets
    ids = torch.randint(0, 49408, (8, 77), generator=torch.Generator().manual_seed(1))
    neg = torch.zeros_like(ids)
    common = dict(guidance_scale=5.0, height=512, width=512, policy=pipe.policy, attn_impl=pipe.models.attn_impl)
    dp_sched = make_ddpm(pipe.scheduler_config, 30)
    tp_sched = make_ddpm(pipe.scheduler_config, DIST_TP_STEPS)
    # the TP request's per-sample LoRA: rows 0-3 ride one rank-4 adapter,
    # rows 4-7 another, sliced by head on every sharded attention
    pair = [make_lora(nets["unet"], seed, torch)["unet"] for seed in (61, 62)]
    tp_lora = {"unet": tree_map(lambda a, b: torch.stack([a] * 4 + [b] * 4), *pair), "text_encoder": None}
    del pair
    refs = {}
    if rank == 0:  # the one-process images on the same card
        refs = {30: sample(nets, dp_sched, ids, neg, generator=sampler_generator(0, dev), **common),
                DIST_TP_STEPS: sample(nets, tp_sched, ids, neg, generator=sampler_generator(0, dev), lora=tp_lora,
                                      **common)}
    dist.coordination_barrier("refs", DIST_TIMEOUT_S)
    dp_img = _leg(torch, report, "dp sample", lambda: sample_data_parallel(
        dp, nets, dp_sched, ids, neg, generator=sampler_generator(0, dev), **common))
    shard_unet_params_tp(nets["unet"], tp)
    tp_img = _leg(torch, report, "tp sample", lambda: sample_2d_parallel(
        tp, nets, tp_sched, ids, neg, generator=sampler_generator(0, dev), lora=tp_lora, **common))
    for key, img, S in (("dp", dp_img, 30), ("tp", tp_img, DIST_TP_STEPS)):
        report[f"{key} shape"] = list(img.shape)
        if rank == 0:
            d = (img.float() - refs[S].float()).abs()
            report[f"{key} image diff"] = [float(d.max()), float(d.mean())]
    del pipe, nets, dp_img, tp_img, refs, tp_lora
    torch.cuda.empty_cache()

    # two data-parallel ID-Booth steps at phase 7's op point: global batch 4 + 4
    op = build_train_op_point(torch)
    policy, models, frozen, cfg = op
    batch = make_train_batch(torch, 8, 512, seed=5)
    optimizer = idbooth.make_optimizer(cfg, total_steps=1000)

    def fresh(seed):
        """The LoRA with B factors off zero (as `_small_train_check` makes
        it): from the first step every A has a gradient, so AdamW's
        sign-like update is not taken of rounding noise."""
        t = idbooth.init_trainable(4 + seed, cfg, models, frozen["unet"])
        g = torch.Generator(device=dev).manual_seed(8 + seed)
        with torch.no_grad():
            for leaf in idbooth.tree_leaves(t)[1::2]:
                leaf.copy_(0.01 * torch.randn(leaf.shape, generator=g, device=dev))
        return t, optimizer.init(t)

    step = idbooth.make_train_step(cfg, models, optimizer, policy=policy, mesh=dp)
    ref_step = idbooth.make_train_step(cfg, models, optimizer, policy=policy)
    rows = rows_of(dp, 8)
    mine = {k: v[rows] for k, v in batch.items()}
    report["rows"] = [rows.start, rows.stop]
    report["train"] = []
    for seed in range(train_seeds):
        start = [leaf.detach().clone() for leaf in idbooth.tree_leaves(fresh(seed)[0])]
        trainable, opt_state = fresh(seed)
        losses = []
        for i in range(2):
            name = f"train step {i}" if seed == 0 else f"train seed {seed} step {i}"
            _, _, m = _leg(torch, report, name, lambda: step(
                trainable, opt_state, frozen, mine, train_step_generator(cfg.seed + seed, i, dev)))
            losses.append(float(m["loss"]))
        leg = {"seed": seed, "losses": losses, "lora sha256": _lora_digest(torch, trainable)}
        dp_update = torch.cat([(a.detach() - b).float().flatten() for a, b in
                               zip(idbooth.tree_leaves(trainable), start)])
        del trainable, opt_state
        torch.cuda.empty_cache()
        if rank == 0:  # one process on the global batch, the same init and draws
            ref_t, ref_o = fresh(seed)
            ref_losses = []
            for i in range(2):
                ref_t, ref_o, m = ref_step(ref_t, ref_o, frozen, batch, train_step_generator(cfg.seed + seed, i, dev))
                ref_losses.append(float(m["loss"]))
            ref_update = torch.cat([(a.detach() - b).float().flatten() for a, b in
                                    zip(idbooth.tree_leaves(ref_t), start)])
            leg["ref losses"] = ref_losses
            leg["update cosine"] = float(torch.nn.functional.cosine_similarity(dp_update, ref_update, dim=0))
            del ref_t, ref_o
        report["train"].append(leg)
        del start, dp_update
        torch.cuda.empty_cache()
    del op, frozen, batch, mine
    torch.cuda.empty_cache()
    dist.coordination_barrier("train done", DIST_TIMEOUT_S)

    # pod-rehearsal's worker at processes 2 × local_devices 1, at its tiny size
    os.makedirs(os.path.join(work, "rehearsal"), exist_ok=True)
    report["rehearsal"] = _leg(torch, report, "rehearsal leg", lambda: run_worker(
        rank, world, 1, port, os.path.join(work, "rehearsal"), device="cuda", backend="gloo",
        timeout_s=DIST_TIMEOUT_S))
    report["s"] = time.time() - t_rank
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _dist_lora_root(torch, root):
    """Three rank-4 UNet LoRAs of identity id_7 as generate reads them:
    <root>/<variant>/id_7/checkpoint-31-6400/pytorch_lora_weights.safetensors."""
    import os

    from faceposegenerator_tpu_torch.diffusion.lora_io import save_lora_safetensors
    from faceposegenerator_tpu_torch.models.unet2d import UNet2DCondition
    from faceposegenerator_tpu_torch.pipelines import sweep

    unet = UNet2DCondition(dtype=torch.bfloat16, seed=1)  # the shapes of SD2.1-base's
    for seed, variant in enumerate(sweep.MODEL_VARIANTS, start=51):
        folder = os.path.join(root, variant, "id_7", "checkpoint-31-6400")
        os.makedirs(folder)
        save_lora_safetensors(make_lora(unet, seed, torch), os.path.join(folder, "pytorch_lora_weights.safetensors"))
    del unet
    torch.cuda.empty_cache()
    return root


def _nccl_generate(torch, card_line, model_dir, lora_root, root):
    """`generate --data_parallel 1` as one NCCL rank through the normal entry
    point (torch's launcher variables, world size 1), beside the same
    command without the flag: one packed batch of 8 (3 variants × 2
    prompts, DDPM 30), K1 960 and K2 1, the PNGs equal."""
    import os

    import numpy as np

    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.core.dist import free_port
    from faceposegenerator_tpu_torch.pipelines import sweep, txt2img

    base = ["generate", "--model_dir", model_dir, "--lora_root", lora_root, "--pack_variants",
            "--num_prompts", str(CLI_TURBO_PROMPTS)]
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    total, out = {}, {}
    for key, extra, probe in (("one process", [], "sample"), ("nccl", ["--data_parallel", "1"],
                                                               "sample_data_parallel")):
        out[key] = os.path.join(root, key.replace(" ", "_"))
        if key == "nccl":
            os.environ.update(env)
        try:
            with step_probe(txt2img, probe, factory=False) as batches:
                _, launches, secs = _run_cli(torch, base + ["--output", out[key]] + extra, card_line)
            if key == "nccl":
                info = dist.proc_info()
                backend = torch.distributed.get_backend()
                dist.barrier("nccl leg")  # NCCL's first collective at world size 1
                if (info.process_count, backend) != (1, "nccl"):
                    fail(f"generate --data_parallel 1 ran in a job of {info.process_count} ranks on {backend}")
        finally:
            if key == "nccl":
                dist.shutdown()
                for k in env:
                    os.environ.pop(k, None)
        _add_counts(total, launches)
        _expect_each(batches.records, REQUEST_LAUNCHES, f"generate ({key}) batch")
        if len(batches.records) != 1:
            fail(f"generate ({key}) ran {len(batches.records)} batches, expected 1")
        print(f"distribution: generate ({key}) {secs:.2f} s, its batch of 8 {batches.records[0]['s']:.3f} s "
              f"({card_line})", flush=True)
    n = 0
    for v in sweep.MODEL_VARIANTS:
        for p in range(CLI_TURBO_PROMPTS):
            name = os.path.join(v, "id_7", f"id_7_{p:03d}.png")
            if not np.array_equal(_png(os.path.join(out["nccl"], name)), _png(os.path.join(out["one process"], name))):
                fail(f"generate --data_parallel 1 {name} differs from the one-process run's")
            n += 1
    print(f"distribution: NCCL rank at world size 1: {n} PNGs bit-equal to the one-process run's ({card_line})",
          flush=True)
    return total


def run_distribution(torch, fa, card, card_line, model_dir, default_secs, train_secs, train_seeds=1):
    """Phase 18: the NCCL leg in this process, K1 at the tensor-parallel
    shapes and K1, K5 and K6 at a rank's data-parallel train step, then the
    gloo rig: DIST_WORLD ranks sharing the card, spawned as `chip_smoke.py
    --dist-rank`, their reports gated here; the rig's train leg runs for
    `train_seeds` LoRA inits and draws. Returns (the phase's launches, its
    forward kernel rows, its backward kernel rows)."""
    import os

    from faceposegenerator_tpu_torch.core.dist import SpawnError, free_port, spawn

    t_phase = time.time()
    total = {}
    with build_dir("distribution") as root:
        os.makedirs(root)
        lora_root = _dist_lora_root(torch, os.path.join(root, "loras"))
        _add_counts(total, _nccl_generate(torch, card_line, model_dir, lora_root, root))
        fwd_rows = check_kernels(torch, fa, card, TP_SHAPES)
        fwd_rows += check_kernels(torch, fa, card, DIST_TRAIN_SHAPES, with_lse=True, per="step")
        bwd_rows = check_backward(torch, fa, card, [s for s in DIST_TRAIN_SHAPES if "vae encode" not in s[0]])
        torch.cuda.empty_cache()
        port = free_port()
        try:
            spawn([[sys.executable, os.path.abspath(__file__), "--dist-rank", str(r), str(DIST_WORLD), str(port),
                    model_dir, root, str(train_seeds)] for r in range(DIST_WORLD)], timeout=DIST_TIMEOUT_S,
                  log_dir=root)
        except SpawnError as e:
            fail(f"distribution: {e}")
        reports = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(DIST_WORLD)]
    rig = time.time() - t_phase
    for rep in reports:
        r = rep["rank"]
        step_expect = STEP_LAUNCHES if r == 0 else DIST_RANK1_STEP  # rank 1 holds only class rows
        expect = {"dp sample": REQUEST_LAUNCHES, "tp sample": {"flash_fwd_d64": 32 * DIST_TP_STEPS,
                                                               "flash_fwd_wide": 1},
                  "train step 0": step_expect, "train step 1": step_expect}
        for leg, want in expect.items():
            if rep[leg]["launches"] != want:
                fail(f"distribution rank {r} {leg} launched {rep[leg]['launches']}, expected {want}")
            _add_counts(total, rep[leg]["launches"])
        if rep["dp shape"] != [8, 512, 512, 3] or rep["tp shape"] != [8, 512, 512, 3]:
            fail(f"distribution rank {r}: images {rep['dp shape']} and {rep['tp shape']}")
        print(f"distribution rank {r} ({rep['device']}, rows {rep['rows']} of the train batch): "
              + ", ".join(f"{leg} {rep[leg]['s']:.3f} s peak {rep[leg]['peak_gib']:.1f} GiB"
                          for leg in (*expect, "rehearsal leg"))
              + f"; {rep['s']:.1f} s in all ({card_line})", flush=True)
    r0 = reports[0]
    for key in ("dp", "tp"):
        mx, mean = r0[f"{key} image diff"]
        print(f"distribution: {key} images against one process: diff max {mx:.3e} mean {mean:.3e} "
              f"(limits 1e-1, 1e-2)", flush=True)
        if not (mx <= 1e-1 and mean <= 1e-2):
            fail(f"distribution: the {key} images disagree with the one-process images")
    for i, leg in enumerate(r0["train"]):
        rel = [abs(a - b) / abs(b) for a, b in zip(leg["losses"], leg["ref losses"])]
        equal = len({rep["train"][i]["lora sha256"] for rep in reports}) == 1
        print(f"distribution: DP train seed {leg['seed']}: losses {leg['losses']} against one process "
              f"{leg['ref losses']} (rel diff {max(rel):.3e}, limit 1e-2); LoRA update cosine "
              f"{leg['update cosine']:.6f} (limit 0.99); the LoRA {'bit-equal' if equal else 'DIFFERENT'} "
              f"across ranks", flush=True)
        if not (max(rel) <= 1e-2 and leg["update cosine"] >= 0.99):
            fail("distribution: the data-parallel train steps disagree with one process")
        if not equal:
            fail("distribution: the replicated LoRA differs across ranks")
    if len(r0["train"]) > 1:
        cos = [leg["update cosine"] for leg in r0["train"]]
        print(f"distribution: LoRA update cosine over {len(cos)} seeds: min {min(cos):.6f} mean "
              f"{sum(cos) / len(cos):.6f} max {max(cos):.6f} ({card_line})", flush=True)
    verdicts = [rep["rehearsal"] for rep in reports]
    for v in verdicts:
        if not (v["ok"] and v["processes"] == 2 and v["global_devices"] == 2 and v["mesh"] == {"data": 2, "model": 1}
                and abs(v["loss2"] - v["loss2_restored"]) < 1e-6
                and all(math.isfinite(v[k]) for k in ("loss1", "loss2", "sample_mean", "rolling_mean"))):
            fail(f"distribution: pod rehearsal verdict {v}")
        if (v["loss1"], v["loss2"]) != (verdicts[0]["loss1"], verdicts[0]["loss2"]):
            fail(f"distribution: pod rehearsal ranks disagree: {verdicts}")
    print(f"distribution: pod rehearsal 2 × 1 on the card over gloo: {json.dumps(verdicts[0])}", flush=True)
    s_req = [rep["dp sample"]["s"] for rep in reports]
    s_step = [rep["train step 1"]["s"] for rep in reports]
    print(f"distribution: per rank, two ranks sharing one card (correctness, not a speedup): DP s/request "
          f"{[round(x, 3) for x in s_req]} (4 of the 8 rows each) beside phase 4's {default_secs:.3f}; TP "
          f"({DIST_TP_STEPS} steps) s/request {[round(rep['tp sample']['s'], 3) for rep in reports]}; DP s/step "
          f"{[round(x, 3) for x in s_step]} (4 of the 8 rows each) beside phase 7's {train_secs:.3f}; phase 18 in "
          f"{rig:.1f} s ({card_line})", flush=True)
    return total, [dict(r, phase=18) for r in fwd_rows], [dict(r, phase=18) for r in bwd_rows]


# Phase 19: the servers over a mesh. The gloo rig's two ranks share the
# card, as in phase 18: a check of the lockstep and the images, not a
# speedup
MESH_WORLD, MESH_TIMEOUT_S = 2, 420.0
# K1 and K2 at a rank's new shapes: a rolling rank's 2 of the 4 slots (4
# UNet rows: L0's 5 self-attentions a tick), and the decode of a mesh
# server rank's 4 of the 8 images (a batch rank's UNet rows, 8, are the
# 4-slot tick's of phase 14, and so are a Picard rank's 4 window positions)
MESH_TICK_SHAPES = [("mesh rolling rank self L0, 2 of 4 slots", 4, 5, 4096, 4096, 64, 5)]
MESH_DECODE_SHAPES = [("mesh server rank vae mid, 4 of 8 images", 4, 1, 4096, 4096, 512, 1)]
MESH_ROLL_REQUESTS, MESH_WINDOW = 5, 8
# MoCo over the data axis: iresnet50 at 112², batch 64 a rank, the embedding
# width as the key width, fp32 with TF32 off (the gate is 1e-4 relative)
MESH_MOCO = dict(network="r50", batch=64, res=112, dim=512, queue=65536, steps=5, lr=0.1)


def _u8_errs(got, want):
    """[max, mean] of |got - want| on [0, 1] for each of two stacks of uint8 images."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)) / 255.0
    return [[float(x.max()), float(x.mean())] for x in d]


def _moco_run(torch, mesh, steps_batches):
    """MESH_MOCO's steps on this rank's rows (the whole batch without a
    mesh): the encoder's BatchNorm over the union of the ranks' rows, so
    that the data-parallel run computes the one-process step. Returns
    (losses, queue on the host, the key encoder's fc weight on the host)."""
    from faceposegenerator_tpu_torch.core.mesh import DATA_AXIS
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.models import iresnet
    from faceposegenerator_tpu_torch.training import moco

    cfg = moco.MoCoConfig(dim=MESH_MOCO["dim"], queue_size=MESH_MOCO["queue"])
    model = iresnet.IResNet(iresnet.config_for(MESH_MOCO["network"], num_features=MESH_MOCO["dim"]), seed=3)
    group = None if mesh is None else mesh.group(DATA_AXIS)

    def apply(params, x):
        return torch.func.functional_call(model, params, (x,), dict(policy=PARITY_POLICY, train=True,
                                                                   bn_group=group, bn_global=True))[0]

    def init(g):
        return {n: p.detach().clone() for n, p in model.named_parameters()
                if n.rsplit(".", 1)[-1] not in iresnet.STATE_NAMES}

    state = moco.init_moco(torch.Generator(device="cuda").manual_seed(5), init, cfg)
    opt = moco.sgd(MESH_MOCO["lr"])
    opt_state = opt.init(state["params_q"])
    losses = []
    with tf32(False):
        for q, k in steps_batches:
            loss, state, opt_state, _ = moco.moco_step(state, apply, opt, opt_state, q, k, cfg, mesh=mesh)
            losses.append(float(loss))
    return losses, state["queue"].cpu().numpy(), state["params_k"]["fc.weight"].cpu().numpy()


def _moco_batches(torch, rows):
    """MESH_MOCO's (query, key) batches of MESH_WORLD × batch images, `rows` of each."""
    g = torch.Generator(device="cuda").manual_seed(9)
    n, res = MESH_WORLD * MESH_MOCO["batch"], MESH_MOCO["res"]
    out = []
    for _ in range(MESH_MOCO["steps"]):
        q = torch.rand(n, res, res, 3, generator=g, device="cuda") * 2 - 1
        k = q + 0.05 * torch.randn(q.shape, generator=g, device="cuda")
        out.append((q[rows], k[rows]))
    return out


def mesh_rank(rank: int, world: int, port: int, model_dir: str, work: str) -> int:
    """One rank of phase 19's gloo rig (`python3 chip_smoke.py --mesh-rank
    RANK WORLD PORT MODEL_DIR WORK`): the ranks share cuda:0 over gloo. Rank 0
    runs the one-process references first; then both run the servers over
    the mesh, one at a time, `sample_parallel(mesh=)` and the MoCo steps.
    Each writes its report (launches, seconds, peak memory a leg; rank 0 the
    errors against its references) to WORK/rank{RANK}.json."""
    import os

    import numpy as np
    import torch

    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.core.mesh import make_mesh, rows_of
    from faceposegenerator_tpu_torch.diffusion import sampler
    from faceposegenerator_tpu_torch.diffusion.lora_io import zero_lora
    from faceposegenerator_tpu_torch.diffusion.parallel_sampler import sample_parallel
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv
    from faceposegenerator_tpu_torch.ops.image import quantize_u8
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
    from faceposegenerator_tpu_torch.serving import GenerationRequest, RollingServer, SamplerServer
    from faceposegenerator_tpu_torch.serving.engine import request_noise

    fused_gn._GN_IMPL = fused_gn_conv._IMPL = "xla"
    t_rank = time.time()
    dist.init_distributed(f"127.0.0.1:{port}", world, rank, platform="cuda", backend="gloo",
                          timeout_s=MESH_TIMEOUT_S)
    mesh = make_mesh(data=world)
    dev = mesh.device
    report = {"rank": rank, "device": str(dev)}
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=torch.bfloat16)
    adapters = {}
    for name, seed in (("a", 71), ("b", 72)):
        adapters[name] = zero_lora(pipe.nets["unet"], pipe.nets["text_encoder"], dtype=torch.bfloat16)
        adapters[name]["unet"] = make_lora(pipe.nets["unet"], seed, torch)["unet"]

    def req(i, seed, lora=None):
        return GenerationRequest(prompt=PROMPTS[i % len(PROMPTS)], negative_prompt=NEGATIVE_PROMPT, seed=seed,
                                 lora_id=lora)

    uniform = [req(i, 300 + i, "a") for i in range(8)]
    mixed = [req(i, 400 + i, lora) for i, lora in enumerate(("a", "b", None, "a", "b", "a", None, "b"))]
    rolled = [req(i, 500 + i, lora) for i, lora in enumerate((None, "a", "b", "a", None)[:MESH_ROLL_REQUESTS])]
    served = SERVED
    steps = served["num_inference_steps"]
    ids, neg = pipe.tokenize([PROMPTS[3]]), pipe.tokenize([NEGATIVE_PROMPT])
    noise = request_noise([600], steps, 64, 64, dev)
    picard = dict(guidance_scale=served["guidance_scale"], height=512, width=512, policy=pipe.policy,
                  attn_impl=pipe.models.attn_impl, noise_override=noise)
    schedule = make_ddpm(pipe.scheduler_config, steps)

    def register(srv):
        for name, tree in adapters.items():
            srv.register_lora(name, tree)
        return srv

    def images(results):
        return np.stack([r.image for r in results])

    def staggered(srv, ticks):
        futs = [srv.submit(r) for r in rolled[:2]]
        _wait_ticks(ticks.records, 3, futs)
        futs += [srv.submit(r) for r in rolled[2:]]  # the fifth waits for a free slot
        return np.stack([f.result(timeout=MESH_TIMEOUT_S).image for f in futs])

    refs = {}
    if rank == 0:  # one process on the same card
        for key, spec, multi in (("uniform", uniform, False), ("mixed", mixed, True)):
            srv = register(SamplerServer(pipe, batch_size=8, max_wait_s=0.5, multi_lora=multi, **served))
            refs[key] = images(srv.generate(spec))
            srv.shutdown()
        srv = register(RollingServer(pipe, batch_size=4, max_wait_s=0.0, **served))
        with step_probe(srv, "_tick", factory=False) as ticks:
            refs["rolling"] = staggered(srv, ticks)
        srv.shutdown()
        refs["picard"] = quantize_u8(sampler.sample(pipe.nets, schedule, ids, neg, **picard)).cpu().numpy()
        refs["moco"] = _moco_run(torch, None, _moco_batches(torch, slice(None)))
        torch.cuda.empty_cache()
    dist.coordination_barrier("refs", MESH_TIMEOUT_S)
    pipe.to_mesh(mesh)  # rank 0's weights, broadcast once; the servers then broadcast none
    got = {}

    for key, spec, multi in (("uniform", uniform, False), ("mixed", mixed, True)):
        srv = SamplerServer(pipe, batch_size=8, max_wait_s=0.5, multi_lora=multi, mesh=mesh, **served)
        with step_probe(sampler, "sample", factory=False) as batches:
            torch.cuda.reset_peak_memory_stats()
            if rank == 0:
                register(srv)  # after the start: through the worker thread to every rank
                got[key] = images(srv.generate(spec))
                if key == "uniform":
                    got["again"] = images(srv.generate(spec))
                report[f"{key} stats"] = srv.stats()
                srv.shutdown()
            srv.join()
        report[f"{key} batches"] = [{k: r[k] for k in ("s", "launches")} for r in batches.records]
        report[f"{key} peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        report[f"{key} adapters"] = [n for n in srv._lora_names]

    # the probes on the class: the worker thread may tick before an instance's probe is set
    with step_probe(RollingServer, "_tick", factory=False) as ticks, \
            step_probe(RollingServer, "_decode1_u8", factory=False) as decodes:
        torch.cuda.reset_peak_memory_stats()
        srv = RollingServer(pipe, batch_size=4, max_wait_s=0.0, mesh=mesh, **served)
        t0 = time.time()
        if rank == 0:
            register(srv)
            got["rolling"] = staggered(srv, ticks)
            report["rolling stats"] = srv.stats()
            srv.shutdown()
        srv.join()
    report["rolling"] = {"s": time.time() - t0, "ticks": [r["launches"] for r in ticks.records],
                         "tick_s": [r["s"] for r in ticks.records],
                         "decodes": [r["launches"] for r in decodes.records],
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    out = _leg(torch, report, "picard", lambda: sample_parallel(
        pipe.nets, schedule, ids, neg, window=MESH_WINDOW, tolerance=0.0, mesh=mesh, return_stats=True, **picard))
    report["picard iters"] = int(out[1])
    got["picard"] = quantize_u8(out[0]).cpu().numpy()
    del pipe, srv, out
    torch.cuda.empty_cache()

    moco_rows = rows_of(mesh, MESH_WORLD * MESH_MOCO["batch"])
    moco = _leg(torch, report, "moco", lambda: _moco_run(torch, mesh, _moco_batches(torch, moco_rows)))
    report["moco losses"] = moco[0]
    if rank == 0:
        for key in ("uniform", "mixed", "rolling", "picard"):
            report[f"{key} errs"] = _u8_errs(got[key], refs[key])
        report["again equal"] = bool(np.array_equal(got["again"], got["uniform"]))
        ref_losses, ref_queue, ref_fc = refs["moco"]
        report["moco ref losses"] = ref_losses
        report["moco loss rel"] = max(abs(a - b) / abs(b) for a, b in zip(moco[0], ref_losses))
        report["moco queue rel"] = float(np.abs(moco[1] - ref_queue).max() / np.abs(ref_queue).max())
        report["moco key fc rel"] = float(np.abs(moco[2] - ref_fc).max() / np.abs(ref_fc).max())
    report["s"] = time.time() - t_rank
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.coordination_barrier("reports", MESH_TIMEOUT_S)
    return 0


def run_mesh_serving(torch, fa, card, card_line, model_dir, served=None):
    """Phase 19: the servers over a mesh. `serve --data_parallel 1` as one
    NCCL rank (torch's launcher variables, world size 1) against the
    one-process `serve` (`served`: phase 17's flags, request and PNG; run
    here when None); K1 and K2 at a rank's new shapes; the gloo rig of
    MESH_WORLD ranks sharing the card (`chip_smoke.py --mesh-rank`), gated
    here; `serve --data_parallel 2` from one command under FPG_BACKEND=gloo.
    Returns (the phase's launches, its forward kernel rows)."""
    import os

    from faceposegenerator_tpu_torch.core.dist import SpawnError, free_port, spawn
    from faceposegenerator_tpu_torch.diffusion.lora_io import save_lora_safetensors, zero_lora
    from faceposegenerator_tpu_torch.models.unet2d import UNet2DCondition

    t_phase = time.time()
    total = {}
    with build_dir("mesh_serving") as root:
        os.makedirs(root)
        if served is None:  # phase 17's command: --multi_lora with one adapter file as "a"
            unet = UNet2DCondition(dtype=torch.bfloat16, seed=1)
            tree = zero_lora(unet, None, dtype=torch.bfloat16)
            tree["unet"] = make_lora(unet, 41, torch)["unet"]
            lora_file = os.path.join(root, "lora", "pytorch_lora_weights.safetensors")
            save_lora_safetensors(tree, lora_file)
            del unet, tree
            torch.cuda.empty_cache()
            argv = ["--model_dir", model_dir, "--lora", f"a={lora_file}", "--multi_lora"]
            body = {"prompt": PROMPTS[0], "negative_prompt": NEGATIVE_PROMPT, "seed": 100, "lora_id": "a"}
            _, one_s, _, pngs, _ = serve_child(argv, {}, os.path.join(root, "serve_one.stderr"), body)
            served = {"argv": argv, "body": body, "png": pngs[0]}
            print(f"mesh serving: one-process serve for the reference, /healthz after {one_s:.2f} s", flush=True)
        nccl_env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
                    "LOCAL_RANK": "0"}
        line, startup_s, request_s, pngs, stats = serve_child(served["argv"] + ["--data_parallel", "1"], nccl_env,
                                                              os.path.join(root, "serve_nccl.stderr"), served["body"])
        if "1 data-parallel rank over nccl" not in line or stats["requests"] != 1:
            fail(f"serve --data_parallel 1: '{line}', stats {stats}")
        equal = pngs[0].shape == served["png"].shape and (pngs[0] == served["png"]).all()
        print(f"mesh serving: serve --data_parallel 1 (one NCCL rank): '{line}', /healthz after {startup_s:.2f} s, "
              f"request {request_s[0]:.3f} s; its PNG {'bit-equal to' if equal else 'DIFFERS from'} the one-process "
              f"serve's ({card_line})", flush=True)
        if not equal:
            fail("serve --data_parallel 1's PNG differs from the one-process serve's")

        fwd_rows = check_kernels(torch, fa, card, MESH_TICK_SHAPES, per="tick")
        fwd_rows += check_kernels(torch, fa, card, MESH_DECODE_SHAPES, per="batch")
        torch.cuda.empty_cache()

        port = free_port()
        try:
            spawn([[sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r), str(MESH_WORLD), str(port),
                    model_dir, root] for r in range(MESH_WORLD)], timeout=MESH_TIMEOUT_S, log_dir=root)
        except SpawnError as e:
            fail(f"mesh serving: {e}")
        reports = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(MESH_WORLD)]
        rig_s = time.time() - t_phase

        line, dp_startup_s, dp_request_s, dp_pngs, dp_stats = serve_child(
            served["argv"] + ["--data_parallel", "2"], {"FPG_BACKEND": "gloo"},
            os.path.join(root, "serve_dp2.stderr"), served["body"])
        if "2 data-parallel ranks over gloo" not in line or dp_stats["requests"] != 1:
            fail(f"serve --data_parallel 2: '{line}', stats {dp_stats}")
        print(f"mesh serving: serve --data_parallel 2 (two gloo ranks on the card, one command): '{line}', /healthz "
              f"after {dp_startup_s:.2f} s, request {dp_request_s[0]:.3f} s ({card_line})", flush=True)
        _u8_diff(dp_pngs[0], served["png"], "serve --data_parallel 2's PNG vs the one-process serve's")

    expect_batch = dict(REQUEST_LAUNCHES)
    for rep in reports:
        r = rep["rank"]
        for key in ("uniform", "mixed"):
            batches = rep[f"{key} batches"]
            if len(batches) != (2 if key == "uniform" else 1):
                fail(f"mesh rank {r} {key}: {len(batches)} batches")
            for b in batches:
                if b["launches"] != expect_batch:
                    fail(f"mesh rank {r} {key} batch launched {b['launches']}, expected {expect_batch}")
                _add_counts(total, b["launches"])
            if rep[f"{key} adapters"] != [None, "a", "b"]:
                fail(f"mesh rank {r} {key}: adapters {rep[f'{key} adapters']}")
        roll = rep["rolling"]
        for t in roll["ticks"]:
            if t != TICK_LAUNCHES:
                fail(f"mesh rank {r} rolling tick launched {t}, expected {TICK_LAUNCHES}")
            _add_counts(total, t)
        for d in roll["decodes"]:
            if d != DECODE1_LAUNCHES:
                fail(f"mesh rank {r} rolling decode launched {d}, expected {DECODE1_LAUNCHES}")
            _add_counts(total, d)
        if sum(len(rr["rolling"]["decodes"]) for rr in reports) != MESH_ROLL_REQUESTS:
            fail(f"mesh rolling: decodes a rank {[len(rr['rolling']['decodes']) for rr in reports]} for "
                 f"{MESH_ROLL_REQUESTS} requests")
        want = {"flash_fwd_d64": 32 * rep["picard iters"], "flash_fwd_wide": 1}
        if rep["picard iters"] != SERVED["num_inference_steps"] or rep["picard"]["launches"] != want:
            fail(f"mesh rank {r} Picard: {rep['picard iters']} iterations, {rep['picard']['launches']}")
        _add_counts(total, rep["picard"]["launches"])
        if rep["moco"]["launches"]:
            fail(f"mesh rank {r} MoCo launched {rep['moco']['launches']}: its encoder has no attention")
        print(f"mesh rank {r} ({rep['device']}): s/batch uniform {[round(b['s'], 3) for b in rep['uniform batches']]}"
              f" (4 of 8 rows, peak {rep['uniform peak_gib']:.1f} GiB), multi_lora "
              f"{[round(b['s'], 3) for b in rep['mixed batches']]} (peak {rep['mixed peak_gib']:.1f} GiB); rolling "
              f"{len(roll['ticks'])} ticks, s/tick median {sorted(roll['tick_s'])[len(roll['tick_s']) // 2]:.4f}, "
              f"{len(roll['decodes'])} decodes, {roll['s']:.2f} s (peak {roll['peak_gib']:.1f} GiB); Picard "
              f"{rep['picard']['s']:.2f} s ({rep['picard iters']} iterations of 4 of 8 positions, peak "
              f"{rep['picard']['peak_gib']:.1f} GiB); MoCo {rep['moco']['s']:.2f} s for {MESH_MOCO['steps']} steps "
              f"(peak {rep['moco']['peak_gib']:.1f} GiB); {rep['s']:.1f} s in all ({card_line})", flush=True)
    r0 = reports[0]
    for key, what in (("uniform", "batch, one adapter"), ("mixed", "multi_lora batch"), ("rolling", "rolling"),
                      ("picard", "sample_parallel(mesh=) tolerance 0 vs the sequential chain")):
        errs = r0[f"{key} errs"]
        worst = max(e[0] for e in errs), max(e[1] for e in errs)
        print(f"mesh serving: {what}: {len(errs)} images against one process, worst max {worst[0]:.3e} mean "
              f"{worst[1]:.3e} (limits 1e-1, 1e-2 each)", flush=True)
        if not all(e[0] <= 1e-1 and e[1] <= 1e-2 for e in errs):
            fail(f"mesh serving: {what} beyond the per-sample gate: {errs}")
    if not r0["again equal"]:
        fail("mesh serving: the same requests again gave other images")
    print(f"mesh serving: MoCo {MESH_MOCO} over 2 ranks: losses {r0['moco losses']} against one process "
          f"{r0['moco ref losses']}: loss rel {r0['moco loss rel']:.2e}, queue {r0['moco queue rel']:.2e}, key "
          f"encoder fc {r0['moco key fc rel']:.2e} of its max abs (limit 1e-4 each) ({card_line})", flush=True)
    if not (r0["moco loss rel"] <= 1e-4 and r0["moco queue rel"] <= 1e-4 and r0["moco key fc rel"] <= 1e-4):
        fail("mesh serving: the data-parallel MoCo steps disagree with one process")
    print(f"mesh serving: phase 19 in {time.time() - t_phase:.1f} s (the rig {rig_s:.1f} s) ({card_line})",
          flush=True)
    return total, [dict(r, phase=19) for r in fwd_rows]


# Phase 20: the data layer and the parity runbook. DATA_PARITY holds its
# sizes (a CPU rehearsal can shrink them): the .rec at the FR op point, the
# loader comparison's batches, the RGBN bench, the CPU side of the RGBN
# verification, and the parity runbook's steps and resolution.
DATA_PARITY = dict(identities=1000, per_identity=4, loader_batches=4, rgbn_steps=10, nir_share=2, cpu_pairs=32,
                   conditional_files=200, parity_steps=5, report_steps=10, resolution=512, unet_batch=2)
NATIVE_GATE = 1.5 / 255  # JAX's tests/test_native_loader.py: native decode against PIL, 112² records
PARITY_TOL, CHAIN_TOL = 5e-4, 5e-3  # cli parity's --tolerance and --full_chain_tolerance defaults
H100_BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM data sheet (700 W)
DEV = "cuda"  # phase 20's device (a CPU rehearsal sets "cpu")
# the kernel calls whose FLOPs phase 20 counts on both routes: K1 and K2 at
# the request's largest shapes (B, H, S, D), K4 at the fused request's L0
# conv (N, H, W, Cin, Cout), K7 at a level-0 projection (M, K, N)
FLOP_SHAPES = dict(k1=(16, 5, 4096, 64), k2=(8, 1, 4096, 512), k4=(16, 64, 64, 320, 320), k7=(8192, 320, 1280))


def _parity_expect(steps, report_steps):
    """The launches of `cli parity --full_chain` at `steps` (fp32: the per-step
    leg and the full chain, each `steps` UNet calls of 32 attentions and one
    decode, every fp32 forward after one split launch) and of parity-all's
    accel-report at `report_steps` with the two presets and the seed floor
    (bf16: exact and floor renders of report_steps full passes; latency, 8
    full + 12 DeepCache partial passes of 10 attentions (LATENCY_LAUNCHES);
    turbo's calibration, 8 full passes of 160 K7 and a decode; its render,
    phase 6's counts; a VAE decode on K2 for each of the five)."""
    f32 = 2 * (steps * 32 + 1)
    parity = {"flash_fwd_f32": f32, "flash_f32_split": f32}
    report = {"flash_fwd_d64": 2 * report_steps * 32 + LATENCY_LAUNCHES["flash_fwd_d64"] + 8 * 32
              + TURBO_LAUNCHES["auto"]["flash_fwd_d64"], "flash_fwd_wide": 5,
              "qdense": CLI_CALIB_LAUNCHES["qdense"] + TURBO_LAUNCHES["auto"]["qdense"]}
    return parity, report


def _write_rec(root):
    """An insightface-layout train.rec/.idx under `root`: the meta record 0
    (labels [first id record, end], empty payload), then identities ×
    per_identity JPEGs of 112² (phase 15's FR images: an identity's colour
    plus noise, quality 90) labelled by identity. Returns the .rec path."""
    import io
    import os

    import numpy as np
    from PIL import Image

    from faceposegenerator_tpu_torch.data import recordio

    n_ids, per = DATA_PARITY["identities"], DATA_PARITY["per_identity"]
    rng = np.random.default_rng(20)
    base = rng.integers(30, 225, (n_ids, 1, 1, 3))
    records = [(np.asarray([n_ids * per + 1, n_ids * per + 1 + n_ids], np.float32), b"")]
    for i in range(n_ids):
        for _ in range(per):
            buf = io.BytesIO()
            img = np.clip(base[i] + rng.normal(0, 25, (112, 112, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            records.append((np.asarray([i], np.float32), buf.getvalue()))
    os.makedirs(root, exist_ok=True)
    rec = os.path.join(root, "train.rec")
    recordio.write_records(rec, os.path.join(root, "train.idx"), records)
    return rec


def _recordio_leg(torch, fr, card_line, root, bins, native_ok):
    """(a): the .rec at the FR op point, the native loader against PIL on the
    first batches, train_fr_run on it and test_fr_run."""
    import numpy as np

    from faceposegenerator_tpu_torch.data import recordio

    t0 = time.time()
    rec = _write_rec(root)
    t_write = time.time() - t0
    batch, n = FR_BENCH["batch"], DATA_PARITY["loader_batches"]
    loaders = {}
    for name, use_native in (("native", True), ("PIL", False)):
        if use_native and not native_ok:
            continue
        ds = recordio.MXFaceDataset(rec, use_native=use_native)
        t0 = time.time()
        got = [b for _, b in zip(range(n), ds.batches(batch, seed=0))]
        loaders[name] = (ds, got, n * batch / (time.time() - t0))
    if native_ok:
        (ds, got, _), (_, want, _) = loaders["native"], loaders["PIL"]
        err = max(float(np.abs(a["images"] - b["images"]).max()) for a, b in zip(got, want))
        same = all(np.array_equal(a["labels"], b["labels"]) for a, b in zip(got, want))
        if not same or err > NATIVE_GATE or ds.pil_batches:
            fail(f"MXFaceDataset native against PIL: labels equal {same}, images {err:.2e} (gate {NATIVE_GATE:.2e}), "
                 f"{ds.pil_batches} batches handed to PIL")
        print(f"recordio: native decode within {err:.2e} of PIL ({err * 255:.2f}/255), labels equal", flush=True)
    print(f"recordio: {DATA_PARITY['identities'] * DATA_PARITY['per_identity']} JPEGs of 112² written as .rec in "
          f"{t_write:.1f} s; host loader img/s over the first {n} batches of {batch}: "
          + ", ".join(f"{k} {v[2]:.1f}" for k, v in loaders.items()) + f" ({card_line})", flush=True)
    train_ds = loaders["native" if native_ok else "PIL"][0]
    run = _fr_run(torch, fr, card_line, train_ds, bins, root, "fr driver on .rec")
    if native_ok and train_ds.pil_batches:
        fail(f"fr driver on .rec: {train_ds.pil_batches} batches fell back to PIL")
    folder = READINGS.get("fr_folder_s_per_step")
    print(f"fr driver on .rec ({'native' if native_ok else 'PIL'} loader): {run['s_per_step_with_load']:.4f} s/step "
          f"with the batch load, beside phase 15's JPEG-folder driver: "
          f"{'not measured in this run' if folder is None else f'{folder:.4f} s/step'} ({card_line})", flush=True)
    return {"loader_img_per_s": {k: v[2] for k, v in loaders.items()}, **run}


def _write_nir(vis_dir, nir_dir, bin_path, nir_bin):
    """Grayscale copies (the NIR channel) of every `nir_share`-th VIS image,
    and a 600-pair NIR .bin of the VIS .bin's images in grayscale."""
    import io
    import os
    import pickle

    from PIL import Image

    os.makedirs(nir_dir, exist_ok=True)
    for i, name in enumerate(sorted(os.listdir(vis_dir))):
        if i % DATA_PARITY["nir_share"] == 0:
            Image.open(os.path.join(vis_dir, name)).convert("L").save(os.path.join(nir_dir, name), quality=90)
    with open(bin_path, "rb") as f:
        bins, issame = pickle.load(f)
    gray = []
    for b in bins:
        buf = io.BytesIO()
        Image.open(io.BytesIO(b)).convert("L").save(buf, format="JPEG", quality=90)
        gray.append(buf.getvalue())
    with open(nir_bin, "wb") as f:
        pickle.dump((gray, issame), f)


def _rgbn_leg(torch, fr, card_line, root, vis_dir, bin_path):
    """(b): phase 15's FR gate at in_channels=4 (AdaFace); iresnet50 on 4
    channels + AdaFace at batch 128 on VISNIRDataset batches; the 600-pair
    VIS and NIR bins through load_bin_4channel and verification.test, the card
    against the CPU."""
    import copy
    import os
    import statistics

    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY, PARITY_POLICY
    from faceposegenerator_tpu_torch.core.rng import train_step_generator
    from faceposegenerator_tpu_torch.data.fr_dataset import prefetch
    from faceposegenerator_tpu_torch.data.visnir import VISNIRDataset, load_bin_4channel
    from faceposegenerator_tpu_torch.evaluation import verification
    from faceposegenerator_tpu_torch.models import iresnet

    gate = _fr_gate(torch, fr, card_line, heads=("AdaFace",), in_channels=4)
    nir_dir, nir_bin = os.path.join(root, "nir"), os.path.join(root, "nir.bin")
    t0 = time.time()
    _write_nir(vis_dir, nir_dir, bin_path, nir_bin)
    t_write = time.time() - t0

    ds = VISNIRDataset(vis_dir, nir_dir)
    n, steps = FR_BENCH["batch"], DATA_PARITY["rgbn_steps"]
    cfg = fr.FRConfig(network=FR_BENCH["network"], loss="AdaFace", batch_size=n, num_classes=ds.num_classes)
    params, state = fr.init_train_state(cfg, 0, DEV, fr.backbone_config(cfg, in_channels=4))
    opt = fr.make_optimizer(cfg, steps_per_epoch=steps)
    opt_state, step = opt.init(params), fr.make_train_step(cfg, opt, DEFAULT_POLICY)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ends, losses = [], []
    batches = prefetch(ds.batches(n))
    for i in range(steps):
        b = next(batches)
        if b["images"].shape[-1] != 4:
            fail(f"VISNIRDataset gave {b['images'].shape}, not RGBN")
        params, state, opt_state, m = step(params, state, opt_state, b, train_step_generator(0, i, DEV))
        losses.append(float(m["loss"]))
        ends.append(time.time())
    peak = torch.cuda.max_memory_allocated() / 2**30
    with_load = statistics.median(b - a for a, b in zip(ends[1:], ends[2:]))
    if not all(math.isfinite(v) for v in losses):
        fail(f"RGBN iresnet50 losses {losses}")
    print(f"rgbn driver: iresnet50 in_channels=4 AdaFace, batch {n}, {ds.num_classes} classes, bf16 compute, {steps} "
          f"steps on VISNIRDataset batches ({len(os.listdir(nir_dir))} of {len(ds)} images with a NIR file; "
          f"written in {t_write:.1f} s): {with_load:.4f} s/step with the batch load and its copy to the card "
          f"(median), {n / with_load:.1f} train img/s, peak memory {peak:.2f} GiB, losses "
          f"{losses[0]:.3f} → {losses[-1]:.3f} ({card_line})", flush=True)
    del params, state, opt_state, step
    torch.cuda.empty_cache()
    # the step alone, as phase 15 times it: one batch already on the card, 4 channels against 3
    bench = _fr_bench(torch, fr, card_line, in_channels=4, others=False)
    torch.cuda.empty_cache()
    three = READINGS.get("fr_bench_s_per_step")
    if three is None:  # phase 15 did not run (perf/torch_data_parity.py alone)
        three = _fr_bench(torch, fr, card_line, others=False)["s_per_step"]
        torch.cuda.empty_cache()
    print(f"rgbn bench: the step on one batch on the card, {bench['s_per_step']:.4f} s/step at in_channels=4 "
          f"against {three:.4f} at 3 (phase 15's fr bench), {bench['s_per_step'] / three:.3f}× ({card_line})",
          flush=True)

    images, issame = load_bin_4channel(bin_path, nir_bin)
    if images.shape[1:] != (112, 112, 4) or len(images) != 2 * len(issame):
        fail(f"load_bin_4channel gave {images.shape} for {len(issame)} pairs")
    cpu = iresnet.IResNet(iresnet.IResNetConfig(depths=FR_GATE["depths"], in_channels=4), device="cpu", seed=21)
    card = copy.deepcopy(cpu).to(DEV)

    def embed_fn(model, device):
        def embed(x):
            with torch.no_grad():
                return model(torch.as_tensor(x, device=device), PARITY_POLICY).cpu().numpy()

        return embed

    k = 2 * DATA_PARITY["cpu_pairs"]
    with tf32(False):
        t0 = time.time()
        acc_all = verification.test((images, issame), embed_fn(card, DEV))[0]
        t_card = time.time() - t0
        acc_card = verification.test((images[:k], issame[: k // 2]), embed_fn(card, DEV))[0]
    t0 = time.time()
    acc_cpu = verification.test((images[:k], issame[: k // 2]), embed_fn(cpu, "cpu"))[0]
    t_cpu = time.time() - t0
    print(f"rgbn verification: load_bin_4channel on 2 × {len(issame)} pairs {images.shape}; a 4-channel IResNet "
          f"{FR_GATE['depths']} at fp32 (TF32 off): accuracy {acc_all:.4f} on the card over all pairs "
          f"({t_card:.2f} s); first {k // 2} pairs card {acc_card:.4f}, CPU {acc_cpu:.4f} ({t_cpu:.1f} s on the host) "
          f"({card_line})", flush=True)
    if acc_card != acc_cpu:
        fail(f"RGBN verification: the card's accuracy {acc_card} on {k // 2} pairs, the CPU's {acc_cpu}")
    return {"gate": gate, "s_per_step_with_load": with_load, "s_per_step": bench["s_per_step"],
            "s_per_step_3ch": three, "peak_gib": peak, "accuracy": acc_all}


def _conditional_leg(vis_dir, root):
    """flat_to_conditional on the first `conditional_files` images of the VIS
    folder, conditional_to_flat back: the same files, byte for byte, and one
    folder an identity."""
    import os

    from faceposegenerator_tpu_torch.data.conditional import conditional_to_flat, flat_to_conditional

    t0 = time.time()
    names = sorted(os.listdir(vis_dir))[: DATA_PARITY["conditional_files"]]
    flat = os.path.join(root, "flat")
    os.makedirs(flat)
    for f in names:
        os.symlink(os.path.join(vis_dir, f), os.path.join(flat, f))
    counts = flat_to_conditional(flat, os.path.join(root, "cond"))
    n = conditional_to_flat(os.path.join(root, "cond"), os.path.join(root, "flat_again"))
    same = names == sorted(os.listdir(os.path.join(root, "flat_again"))) and all(
        open(os.path.join(vis_dir, f), "rb").read() == open(os.path.join(root, "flat_again", f), "rb").read()
        for f in names)
    ids = {f.split("_")[0] for f in names}
    if not same or n != len(names) or sum(counts.values()) != n or set(counts) != ids:
        fail(f"conditional layouts: {len(counts)} identities of {len(ids)}, {n} files back of {len(names)}, "
             f"same bytes {same}")
    print(f"conditional layouts: {n} files into {len(counts)} identity folders and back, byte-equal, "
          f"{time.time() - t0:.1f} s", flush=True)


def _native_embed_leg(torch, card_line, images, root, native_ok):
    """(c): phase 15's JPEG tree through extract_embeddings_streaming with the
    native decode (the default) and with PIL: the same files without faces,
    the embeddings' cosines, img/s. Without the native loader it runs
    nothing: PIL's streaming embed alone is phase 15's."""
    import os

    import numpy as np

    if not native_ok:
        print("streaming embed, native decode against PIL: left out (no native loader)", flush=True)
        return {}

    from faceposegenerator_tpu_torch import native
    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY
    from faceposegenerator_tpu_torch.models import iresnet, mtcnn
    from faceposegenerator_tpu_torch.pipelines import embed_extract as ee

    r100 = iresnet.IResNet(iresnet.config_for("r100"), dtype=torch.bfloat16, device=DEV, seed=5)
    _damp_residuals(torch, r100)
    crop_embed = ee.make_crop_embed_fn(r100, DEFAULT_POLICY, device=DEV)
    det = mtcnn.MTCNN(mtcnn.brightness_cascade_params(), device=DEV)
    runs = {}
    for name, use_native in (("native", True), ("PIL", False)):
        if use_native and not native_ok:
            continue
        calls = []
        if use_native:  # every batch must go through the native decoder: no quiet fallback to PIL
            mod = native.load()
            saved = mod.decode_batch
            mod.decode_batch = lambda *a, **kw: (calls.append(1), saved(*a, **kw))[1]
        out = os.path.join(root, name)
        try:
            t0 = time.time()
            res = ee.extract_embeddings_streaming(images, out, crop_embed, det, batch_size=EMBED_BENCH["batch"],
                                                  use_native=use_native)
            secs = time.time() - t0
        finally:
            if use_native:
                mod.decode_batch = saved
        n_files = sum(len(fs) for _, _, fs in os.walk(images))
        if use_native and len(calls) != -(-n_files // EMBED_BENCH["batch"]):
            fail(f"streaming embed: {len(calls)} native decodes for {n_files} JPEGs at batch {EMBED_BENCH['batch']}")
        runs[name] = (sorted(res["files_without_faces"]), out, n_files / secs)
    if native_ok:
        (miss_n, out_n, _), (miss_p, out_p, _) = runs["native"], runs["PIL"]
        files = sorted(os.path.join(d, f) for d in os.listdir(out_p) if os.path.isdir(os.path.join(out_p, d))
                       for f in os.listdir(os.path.join(out_p, d)))
        cos = [float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
               for a, b in ((np.load(os.path.join(out_n, f)), np.load(os.path.join(out_p, f))) for f in files)]
        with open(os.path.join(out_n, "files_without_faces.json")) as fa_, \
                open(os.path.join(out_p, "files_without_faces.json")) as fb:
            same_json = json.load(fa_) == json.load(fb)
        print(f"streaming embed, native decode against PIL: {len(files)} embeddings, cosine min {min(cos):.5f} "
              f"mean {np.mean(cos):.5f}; files without faces equal {same_json and miss_n == miss_p} "
              f"({len(miss_p)})", flush=True)
        if not (same_json and miss_n == miss_p) or min(cos) < 0.99:
            fail(f"streaming embed native against PIL: files without faces {miss_n} / {miss_p}, cosine min {min(cos)}")
    print(f"streaming embed img/s (r100 bf16, batch {EMBED_BENCH['batch']}, the bright-square cascade): "
          + ", ".join(f"{k} {v[2]:.1f}" for k, v in runs.items()) + f" ({card_line})", flush=True)
    return {k: v[2] for k, v in runs.items()}


def _weights_root(torch, root, model_dir):
    """parity-all's layout (cli.py:899-913): sd/ → phase 12's directory,
    arcface.pth (phase 15's damped r100 in insightface keys, its convs
    bias-free), mtcnn/ (the bright-square cascade as facenet-pytorch
    pnet.pt, rnet.pt, onet.pt)."""
    import os

    from faceposegenerator_tpu_torch.bridge.torch_weights import export_iresnet_state_dict
    from faceposegenerator_tpu_torch.models import iresnet, mtcnn

    os.makedirs(os.path.join(root, "mtcnn"), exist_ok=True)
    os.symlink(model_dir, os.path.join(root, "sd"))
    r100 = iresnet.IResNet(iresnet.config_for("r100"), device="cpu", seed=5)
    _damp_residuals(torch, r100)
    with torch.no_grad():
        for m in r100.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.zero_()
    torch.save({k: torch.from_numpy(v) for k, v in export_iresnet_state_dict(r100).items()},
               os.path.join(root, "arcface.pth"))
    sd = mtcnn.export_mtcnn_state_dict(mtcnn.brightness_cascade_params())
    for net in ("pnet", "rnet", "onet"):
        torch.save({k[len(net) + 1:]: torch.from_numpy(v) for k, v in sd.items() if k.startswith(net + ".")},
                   os.path.join(root, "mtcnn", f"{net}.pt"))


def _parity_leg(torch, card_line, model_dir, root):
    """(d): `cli parity-all` on a weights root of phase 12's directory, phase
    15's r100 and the bright-square MTCNN, on the card at fp32 with TF32 off.
    Its parity leg is `cli parity --full_chain` at SD2.1-base widths, held
    to the tolerances and the exact fp32 attention counts; its accel-report
    to the presets' default gates and their counts. Returns its launches."""
    import os

    from faceposegenerator_tpu_torch import cli

    steps, res = DATA_PARITY["parity_steps"], DATA_PARITY["resolution"]
    want_parity, want_report = _parity_expect(steps, DATA_PARITY["report_steps"])
    weights = os.path.join(root, "weights")
    os.makedirs(root, exist_ok=True)
    _weights_root(torch, weights, model_dir)
    out_all = os.path.join(root, "parity_all.json")
    tallies, saved = [], cli.cmd_parity

    def parity_tallied(argv):  # the parity leg's attention shapes, apart from the accel-report's
        with shape_tally() as tally:
            out = saved(argv)
        tallies.append(tally.shapes)
        return out

    cli.cmd_parity = parity_tallied
    try:
        # the default gates: every preset's PSNR and ArcFace cosine against the seed floor measured here
        with tf32(False), step_probe(cli, "cmd_parity", factory=False) as legs, \
                step_probe(cli, "cmd_accel_report", factory=False) as reports:
            text, launches, secs = _run_cli(
                torch, ["parity-all", "--weights_root", weights, "--steps", str(steps), "--report_steps",
                        str(DATA_PARITY["report_steps"]), "--resolution", str(res), "--output", out_all], card_line)
    finally:
        cli.cmd_parity = saved
    with open(out_all) as f:
        verdict_all = json.load(f)
    verdict = verdict_all["legs"]["parity"]
    chain = verdict["full_chain"]
    by_dim = {}
    for (b, h, sq, skv, d), c in tallies[0].items():
        by_dim[d] = by_dim.get(d, 0) + c
    f32 = {64: steps * 32 * 2, 512: 2}  # K1's fp32 instance 32 a UNet call, K2's 1 a decode, in both legs
    print(f"parity at {res}², {steps} steps, fp32 (TF32 off): text {verdict['text_max_abs']:.2e}, ε̂ per step "
          f"{', '.join(f'{v:.2e}' for v in verdict['eps_max_abs_per_step'])}, decode {verdict['image_max_abs']:.2e} "
          f"(tolerance {PARITY_TOL}); full chain latents per step "
          f"{', '.join(f'{v:.2e}' for v in chain['latent_max_abs_per_step'])}, image {chain['image_max_abs']:.2e} "
          f"(tolerance {CHAIN_TOL}); missing keys text {verdict['text_missing_keys']} unet "
          f"{verdict['unet_missing_keys']} vae {verdict['vae_missing_keys']}; fp32 attention launches by head dim "
          f"{json.dumps(by_dim)}; {legs.records[0]['s']:.1f} s ({card_line})", flush=True)
    if not (verdict["pass"] and chain["pass"] and max(verdict["eps_max_abs_per_step"]) < PARITY_TOL
            and verdict["image_max_abs"] < PARITY_TOL and verdict["text_max_abs"] < PARITY_TOL
            and chain["latent_max_abs"] < CHAIN_TOL and chain["image_max_abs"] < CHAIN_TOL):
        fail(f"cli parity: verdict {json.dumps(verdict)}")
    if legs.records[0]["launches"] != want_parity or by_dim != f32:
        fail(f"cli parity launched {legs.records[0]['launches']} ({by_dim} by head dim), expected {want_parity} "
             f"({f32})")
    gates = verdict_all["legs"]["preset_quality"]["gates"]
    report_launches = reports.records[0]["launches"]
    print(f"parity-all: pass {verdict_all['pass']}, skipped {verdict_all['skipped']}; parity leg "
          f"{legs.records[0]['s']:.1f} s (arcface: {json.dumps({k: v for k, v in verdict['arcface'].items() if k != 'pth'})}"
          f", mtcnn net max abs {max(verdict['mtcnn']['net_max_abs'].values()):.2e}, cascade detections "
          f"{verdict['mtcnn']['cascade_detections']}), accel-report {reports.records[0]['s']:.1f} s launching "
          f"{json.dumps(report_launches)}; seed floor {json.dumps(verdict_all['legs']['preset_quality']['report']['seed_floor'])}; "
          f"gates {json.dumps(gates)}; {secs:.1f} s in all ({card_line})", flush=True)
    report_gated = {k: report_launches.get(k, 0) for k in want_report}
    if not verdict_all["pass"] or verdict_all["skipped"] or report_gated != want_report:
        fail(f"cli parity-all: pass {verdict_all['pass']}, skipped {verdict_all['skipped']}, accel-report "
             f"{report_gated} (expected {want_report})")
    return launches, {"parity_all_s": secs, "parity_leg_s": legs.records[0]["s"],
                      "accel_report_s": reports.records[0]["s"]}


def _flops_leg(torch, card_line, default_secs):
    """(e): core.flops.cost_analysis of a UNet call at batch 2 × 512² and of
    K1, K2, K4 and K7 calls on their kernel routes against their plain
    routes (the library's aten counts), then the txt2img request's FLOPs and
    its rate at phase 4's s/request."""
    from faceposegenerator_tpu_torch.core import flops
    from faceposegenerator_tpu_torch.core.precision import DEFAULT_POLICY
    from faceposegenerator_tpu_torch.ops import flash_attention as fa
    from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
    from faceposegenerator_tpu_torch.ops import qdense as qd
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16, device=DEV)
    nets, res, b = pipe.nets, DATA_PARITY["resolution"], DATA_PARITY["unet_batch"]
    g = torch.Generator(device=DEV).manual_seed(22)
    lat = torch.randn(b, res // 8, res // 8, 4, generator=g, device=DEV)
    ctx = torch.randn(b, 77, pipe.models.unet_cfg.cross_attention_dim, generator=g, device=DEV).to(torch.bfloat16)
    t = torch.full((b,), 500, device=DEV)
    rows = {}
    with torch.inference_mode():
        rows["unet"] = [flops.cost_analysis(nets["unet"], lat, t, ctx, DEFAULT_POLICY, attn_impl=a)
                        for a in ("auto", "reference")]
        bb, h, s_, d = FLOP_SHAPES["k1"]
        q, k, v = _inputs(torch, g, bb, h, s_, s_, d)
        rows["flash_fwd_d64"] = [flops.cost_analysis(fa.flash_fwd_d64, q, k, v, d**-0.5),
                                 flops.cost_analysis(fa.attention_plain, q, k, v, d**-0.5)]
        want_attn = 4.0 * bb * h * s_ * s_ * d
        bb, h, s_, d = FLOP_SHAPES["k2"]
        q, k, v = _inputs(torch, g, bb, h, s_, s_, d)
        rows["flash_fwd_wide"] = [flops.cost_analysis(fa.flash_fwd_wide, q, k, v, d**-0.5),
                                  flops.cost_analysis(fa.attention_plain, q, k, v, d**-0.5)]
        del q, k, v
        x, gamma, beta, conv = _conv_inputs(torch, g, *FLOP_SHAPES["k4"])
        rows["gn_silu_conv3x3"] = [
            flops.cost_analysis(fgc.gn_silu_conv3x3, x, gamma, beta, conv, 32, 1e-5),
            flops.cost_analysis(fgc.gn_silu_conv3x3_plain, x, gamma, beta, conv.weight, conv.bias, 32, 1e-5)]
        m, kk, n = FLOP_SHAPES["k7"]
        xq = torch.randn(m, kk, generator=g, device=DEV).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (n, kk), generator=g, device=DEV).to(torch.int8)
        sq = torch.rand(n, generator=g, device=DEV) * 1e-2
        rows["qdense"] = [flops.cost_analysis(qd.qdense_kernel, xq, wq, sq), flops.cost_analysis(qd.qdense_plain, xq, wq, sq)]
    for name, (kernel, plain) in rows.items():
        print(f"flops {name}: kernel route {kernel['flops']:.6e} (aten {sum(kernel['aten_flops'].values()):.6e}, "
              f"kernels {json.dumps(kernel['kernel_flops'])}), plain route {plain['flops']:.6e}", flush=True)
        if kernel["flops"] != plain["flops"] or kernel["flops"] <= 0 or plain["kernel_flops"]:
            fail(f"flops {name}: the kernel route counts {kernel['flops']}, the plain route {plain['flops']}")
    if rows["flash_fwd_d64"][0]["flops"] != want_attn:
        fail(f"flops flash_fwd_d64: {rows['flash_fwd_d64'][0]['flops']} where 4·B·H·Sq·Skv·D is {want_attn}")

    ids = torch.zeros((16, 77), dtype=torch.long, device=DEV)
    lat16 = torch.randn(8, res // 8, res // 8, 4, generator=g, device=DEV)

    def request():  # phase 4's request: CLIP on 16 rows, 30 UNet calls on the CFG batch of 16, the VAE on 8
        with torch.inference_mode():
            c = nets["text_encoder"](ids, DEFAULT_POLICY)
            for _ in range(30):
                nets["unet"](torch.cat([lat16, lat16]), 500, c, DEFAULT_POLICY)
            nets["vae"].decode(lat16, DEFAULT_POLICY)

    s = flops.summarize(request, peak_flops_per_sec=H100_BF16_PEAK,
                        runtime_s=default_secs if math.isfinite(default_secs) else None)
    rate = (f"{s['achieved_flops_per_sec'] / 1e12:.1f} TFLOP/s at phase 4's {default_secs:.3f} s/request, "
            f"{100 * s['tensor_core_utilization']:.1f}% of the {H100_BF16_PEAK / 1e12:.0f} TFLOP/s bf16 peak"
            if "achieved_flops_per_sec" in s else "no rate: phase 4 did not run")
    print(f"flops: txt2img request (batch 8, 512², 30 steps, CFG) {s['flops'] / 1e12:.3f} TFLOP; {rate} "
          f"({card_line})", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return {"request_tflop": s["flops"] / 1e12, "utilization": s.get("tensor_core_utilization"),
            "unet_call_tflop": rows["unet"][0]["flops"] / 1e12}


def run_data_parity(torch, card_line, model_dir, data, default_secs=float("nan")):
    """Phase 20: the data layer and the parity runbook (alone:
    `perf/torch_data_parity.py`). On phase 12's directory and phase 15's
    files under `data` (`cli_inputs`): the native loader's build, the
    RecordIO leg, the RGBN leg, the conditional layouts and the streaming
    embed with native decode, which launch no TPU kernel; the parity runbook
    (`cli parity-all`, whose first leg is `cli parity`), whose launches it
    returns; the FLOP
    counts, whose comparison launches it does not count. A missing g++ or
    jpeglib.h is printed on its own line and leaves out the native legs only;
    a build failure with both there fails the phase."""
    import os

    from faceposegenerator_tpu_torch import native
    from faceposegenerator_tpu_torch.evaluation import verification
    from faceposegenerator_tpu_torch.training import fr

    t_phase = time.time()
    inputs = cli_inputs(data)
    missing = native.toolchain_missing()
    t0 = time.time()
    if missing:
        print(f"native loader: {missing} is missing on this machine; the native legs are left out", flush=True)
    elif native.load() is None:
        fail(f"native loader: g++ and jpeglib.h are here, and the build failed: {native.build_error()}")
    else:
        print(f"native loader: built in {time.time() - t0:.2f} s ({native.load().path.name})", flush=True)
    native_ok = missing is None
    _reset_launch_counts()
    bins = {"lfw": verification.load_bin(inputs["fr_bin"])}
    leg_s = {}

    def leg(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        torch.cuda.empty_cache()
        leg_s[name] = round(time.time() - t0, 1)
        return out

    with build_dir("data_parity") as root:
        recordio = leg("recordio", _recordio_leg, torch, fr, card_line, os.path.join(root, "rec"), bins, native_ok)
        rgbn = leg("rgbn", _rgbn_leg, torch, fr, card_line, os.path.join(root, "rgbn"), inputs["fr_flat"],
                   inputs["fr_bin"])
        leg("conditional", _conditional_leg, inputs["fr_flat"], os.path.join(root, "conditional"))
        embed = leg("embed", _native_embed_leg, torch, card_line, inputs["embed_images"], os.path.join(root, "embed"),
                    native_ok)
        data_launches = {k: v for k, v in _launch_counts().items() if v}
        if data_launches:
            fail(f"phase 20's data legs launched {data_launches}: they run no TPU kernel")
        launches, secs = leg("parity", _parity_leg, torch, card_line, model_dir, os.path.join(root, "parity"))
    flop = leg("flops", _flops_leg, torch, card_line, default_secs)  # its launches compare routes: not counted
    print(f"data and parity: phase 20 in {time.time() - t_phase:.1f} s, seconds a leg {json.dumps(leg_s)} "
          f"({card_line}); summary {json.dumps({'recordio': recordio, 'rgbn': {k: v for k, v in rgbn.items() if k != 'gate'}, 'embed_img_per_s': embed, 'parity': secs, 'flops': flop})}",
          flush=True)
    return launches


def _kernel_entries(fwd_rows, bwd_rows, q_rows, i8_rows, gn_rows, conv_rows, f32, launches, ptxas, sass=None):
    """The kernels line: one entry per counted kernel. `ptxas` holds each
    wgmma or fp32 kernel function's registers and spills by instance;
    `sass` its count of HGMMA instructions and of those with TF32 operands
    in the built library."""
    from faceposegenerator_tpu_torch.ops._build import SOURCE_OF

    sass = sass or {}

    sources = {name: f"faceposegenerator_tpu_torch/csrc/{src}.cu" for name, src in SOURCE_OF.items()}
    kernels = []
    for name in ("flash_fwd_d64", "flash_fwd_wide"):
        mine = [r for r in fwd_rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["bound_ms"])  # the shape with the most work
        kernels.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=top["library_ms"],
            shape=f"{top['shape']} B{top['B']}", lse_max_err=max(r["lse_max_err"] or 0.0 for r in mine),
            tflops=top["tflops"], **({"ptxas": ptxas[f"{name}_kernel"]} if f"{name}_kernel" in ptxas else {}),
            # phase 12's shapes (ToMe, decode_chunk), phase 14's (the rolling tick and decode),
            # phase 16's (the eval ViTs, GradCAM, make_heatmap_fn), phase 18's (a rank's heads
            # under tensor parallelism, a rank's 4 rows of the data-parallel train step) and phase
            # 19's (a rolling rank's 2 slots, a mesh server rank's decode), each with the
            # contract's numbers and the launches a request (tick, batch, probe, call, step) its
            # phase makes
            shapes=[dict(shape=f"{r['shape']} B{r['B']}", B=r["B"], H=r["H"], Sq=r["Sq"], Skv=r["Skv"], D=r["D"],
                         ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"], max_abs_err=r["max_abs_err"], tflops=r["tflops"],
                         lse_max_err=r["lse_max_err"], **{k: v for k, v in r.items() if k.startswith("launches_per_")})
                    for r in mine if r.get("phase") in (12, 14, 16, 18, 19)],
        ))
    top = max(f32["fwd"], key=lambda r: r["bound_ms"])
    kernels.append(dict(
        name="flash_fwd_f32", route="cuda", source=sources["flash_fwd_f32"], replaces=REPLACES["flash_fwd_f32"],
        launches=launches["flash_fwd_f32"], max_abs_err=max(r["max_abs_err"] for r in f32["fwd"]), ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=top["library_ms"],
        shape=f"{top['shape']} B{top['B']}", lse_max_err=max(r["lse_max_err"] or 0.0 for r in f32["fwd"]),
        tflops=top["tflops"], tf32_err=f32["tf32"], bound_basis="3xTF32", ptxas=ptxas.get("flash_fwd_f32_kernel"),
        sass_hgmma=sass.get("flash_fwd_f32_kernel"),
    ))
    for name, key, fn in (("flash_f32_split", "split", "flash_f32_split_kernel"),
                          ("gn_conv_f32_split", "conv_split", "gn_conv_f32_split_kernel")):
        top = max(f32[key], key=lambda r: r["bound_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=sources[name], replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in f32[key]), ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=None,
            shape=f"{top['shape']} B{top['B']}" if "B" in top else top["shape"], ptxas=ptxas.get(fn),
        ))
    for kind in ("d64", "wide", "f32"):
        mine = [r for r in (f32["bwd"] if kind == "f32" else bwd_rows) if r["kernel"] == f"flash_bwd_{kind}"]
        top = max(mine, key=lambda r: r["pair_bound_ms"])
        for p, errs in (("dkv", ("dk_err", "dv_err")), ("dq", ("dq_err",))):
            name = f"flash_bwd_{kind}_{p}"
            kernels.append(dict(
                name=name, route="cuda", source=sources[name],
                replaces=REPLACES[name], launches=launches[name],
                max_abs_err=max(r[e][0] for r in mine for e in errs), ms=top[f"{p}_ms"],
                plain_ms=top["plain_ms"], bound_ms=top[f"{p}_bound_ms"], bound_by=top[f"{p}_bound_by"],
                library_ms=top["library_ms"], shape=f"{top['shape']} B{top['B']}", pair_ms=top["pair_ms"],
                tflops=top[f"{p}_tflops"], pair_tflops=top["tflops"],
                **({"ptxas": ptxas[f"{name}_kernel"]} if f"{name}_kernel" in ptxas else {}),
                **({"bound_basis": "3xTF32", "sass_hgmma": sass.get(f"{name}_kernel")} if kind == "f32" else {}),
                # K6's three passes are instances of one template (dV and dK for the dK/dV entry)
                **({"ptxas": ptxas.get("flash_bwd_wide_kernel"), "sass": sass.get("flash_bwd_wide_kernel")}
                   if kind == "wide" else {}),
                # phase 16's gradient shapes (GradCAM, make_heatmap_fn) and phase 18's (a rank's
                # data-parallel train step)
                shapes=[dict(shape=f"{r['shape']} B{r['B']}", B=r["B"], H=r["H"], Sq=r["Sq"], Skv=r["Skv"], D=r["D"],
                             ms=r[f"{p}_ms"], pair_ms=r["pair_ms"], plain_ms=r["plain_ms"],
                             bound_ms=r[f"{p}_bound_ms"], bound_by=r[f"{p}_bound_by"], library_ms=r["library_ms"],
                             max_abs_err=max(r[e][0] for e in errs), grad_max_abs=r["grad_max_abs"],
                             **{k: v for k, v in r.items() if k.startswith("launches_per_")})
                        for r in mine if r.get("phase") in (16, 18)],
            ))
    # K7 and K8: no single library call computes their function (the int8
    # GEMM alone, bf16 F.linear and exact SDPA are yardsticks, in extra keys).
    # K8's ms is its attention launch on ready codes against that launch's
    # bound; `wrapper_ms` is the whole call (its three launches) against the
    # function's bound from bf16 (or fp32) q, k, v, `fn_bound_ms`.
    for name, rows in (("qdense", q_rows), ("flash_int8", i8_rows), ("qdense_f32", f32["qdense"]),
                       ("flash_int8_f32", f32["int8"])):
        top = max(rows, key=lambda r: r["bound_ms"] + (r.get("mode") == "static") * 1e-9)
        fn = "flash_int8_kernel" if name.startswith("flash") else "qdense_kernel"
        if name.startswith("qdense"):
            linear = "bf16_linear_ms" if name == "qdense" else "f32_linear_ms"
            extra = dict(int_mm_ms=top["int_mm_ms"], mode=top["mode"], **{linear: top[linear]},
                         shape=f"{top['shape']} M{top['M']} K{top['K']} N{top['N']}", ms=top["ms"],
                         bound_ms=top["bound_ms"], bound_by=top["bound_by"])
        else:
            other = "k1_ms" if name == "flash_int8" else "f32_ms"
            extra = dict(sdpa_ms=top["sdpa_ms"], shape=f"{top['shape']} B{top['B']}", **{other: top[other]},
                         ms=top["attend_ms"], bound_ms=top["attend_bound_ms"], bound_by=top["attend_bound_by"],
                         wrapper_ms=top["ms"], fn_bound_ms=top["bound_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=sources[name], replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows), plain_ms=top["plain_ms"], library_ms=None,
            ptxas=ptxas.get(fn), sass=sass.get(fn), **extra,
        ))
    # their quantize launches: bit-exact against their plain versions, bound by bytes
    wide = [r for r in q_rows if "quant_ms" in r]
    top = max(wide, key=lambda r: r["quant_bound_ms"] + (r.get("mode") == "dynamic") * 1e-9)
    kernels.append(dict(
        name="qdense_quant", route="cuda", source=sources["qdense_quant"], replaces=REPLACES["qdense_quant"],
        launches=launches["qdense_quant"], max_abs_err=0.0, ms=top["quant_ms"], plain_ms=top["quant_plain_ms"],
        bound_ms=top["quant_bound_ms"], bound_by="bytes", library_ms=None, mode=top["mode"],
        shape=f"{top['shape']} M{top['M']} K{top['K']}", ptxas=ptxas.get("qdense_quant_kernel"),
    ))
    top = max(i8_rows, key=lambda r: r["bound_ms"])
    for name, key, fn in (("flash_int8_amax", "amax", "flash_int8_amax_kernel"),
                          ("flash_int8_codes", "codes", "flash_int8_codes_kernel")):
        kernels.append(dict(
            name=name, route="cuda", source=sources[name], replaces=REPLACES[name], launches=launches[name],
            max_abs_err=0.0, ms=top[f"{key}_ms"], plain_ms=top[f"{key}_plain_ms"], bound_ms=top[f"{key}_bound_ms"],
            bound_by="bytes", library_ms=None, shape=f"{top['shape']} B{top['B']}", ptxas=ptxas.get(fn),
        ))
    # K3 and K4: the library time is F.group_norm (+ F.silu), and the default
    # route's plain GroupNorm+SiLU with cuDNN's conv. K3's ms is its launch
    # on ready buffers, `wrapper_ms` the call, `host_us` the wrapper's host
    # time a call.
    for name, rows in (("fused_group_norm", gn_rows), ("gn_silu_conv3x3", conv_rows),
                       ("gn_silu_conv3x3_f32", f32["conv"])):
        top = max(rows, key=lambda r: r["bound_ms"])
        fn = {"gn_silu_conv3x3": "gn_k4_conv", "gn_silu_conv3x3_f32": "gn_k4_conv_f32"}.get(name)
        k3 = name == "fused_group_norm"
        kernels.append(dict(
            name=name, route="cuda", source=sources[name], replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=top["launch_ms" if k3 else "ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=top["library_ms"], shape=f"{top['shape']} N{top['N']}",
            **({"tflops": top["tflops"], "ptxas": ptxas.get(fn)} if fn else {}),
            **({"bound_basis": "3xTF32", "sass_hgmma": sass.get(fn)} if name == "gn_silu_conv3x3_f32" else {}),
            **({"wrapper_ms": top["ms"], "host_us": top["host_us"], "ptxas": ptxas.get("gn_k3_cluster"),
                "f32": {k: max(f32["gn"], key=lambda r: r["bound_ms"])[k]
                        for k in ("shape", "ms", "launch_ms", "host_us", "plain_ms", "library_ms", "bound_ms")}}
               if k3 else {}),
        ))
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    try:
        from faceposegenerator_tpu_torch.ops import _build
        from faceposegenerator_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t_start = t0 = time.time()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    ptxas = {}  # registers and spills (each instance) of the wgmma and fp32 kernels, for their entries
    for name in libs:
        # e.g. "wgmma.mma_async instructions are serialized": a kernel that builds and is right, but slow
        for line in _build.build_log(name).splitlines():
            if "Performance Loss" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        for rep in _build.ptxas_report(name):
            print(f"ptxas {name} {rep['function']}: {rep.get('registers')} registers, "
                  f"{rep.get('spill_stores')} bytes spill stores, {rep.get('spill_loads')} bytes spill loads",
                  flush=True)
            if rep["function"].startswith(("flash_fwd_d64", "flash_fwd_wide", "flash_bwd_d64", "flash_bwd_wide",
                                           "flash_fwd_f32", "flash_bwd_f32", "flash_f32_split", "gn_k4_conv",
                                           "gn_conv_f32_split", "gn_k3_cluster", "qdense_kernel",
                                           "qdense_quant_kernel", "flash_int8")):
                ptxas.setdefault(rep["function"], []).append(
                    {k: rep.get(k) for k in ("registers", "spill_stores", "spill_loads")})
    # the fp32 attention kernels and K4's fp32 instance must issue their
    # products as TF32 HGMMA
    sass = {f: n for f, n in _build.sass_hgmma("flash_f32").items() if f.startswith(("flash_fwd", "flash_bwd"))}
    print(f"sass flash_f32: HGMMA instructions, with TF32 operands: {json.dumps(sass)}", flush=True)
    sass_conv = _build.sass_hgmma("gn_conv")
    print(f"sass gn_conv: HGMMA instructions, with TF32 operands: {json.dumps(sass_conv)}", flush=True)
    sass["gn_k4_conv_f32"] = sass_conv.get("gn_k4_conv_f32", [0, 0])
    for f, (n, tf32_n) in sass.items():
        if n == 0 or tf32_n != n:
            fail(f"{f} issues {n} HGMMA instructions, {tf32_n} of them TF32: an fp32 kernel's must all be TF32")
    # K7 and K8 (both instances each) run on int8 wgmma: IGMMA in every GEMM
    # instance, no mma.sync (IMMA) anywhere; their conversion and MUFU counts
    sass_int8 = {name: _build.sass_ops(name) for name in ("qdense", "flash_int8")}
    print(f"sass int8 (per kernel instance): {json.dumps(sass_int8)}", flush=True)
    for name, funcs in sass_int8.items():
        for f in funcs:
            if f["IMMA"] or (f["function"] in ("qdense_kernel", "flash_int8_kernel") and not f["IGMMA"]):
                fail(f"{name}.cu {f['function']}: {f['IGMMA']} IGMMA, {f['IMMA']} IMMA; K7 and K8 must run on wgmma")
    for f in sass_int8["qdense"] + sass_int8["flash_int8"]:
        sass.setdefault(f["function"], []).append({k: v for k, v in f.items() if k != "function"})
    # the bf16 backward (K5, K6: every head-dim and pass instance) runs on
    # wgmma: HGMMA in every instance, no mma.sync (HMMA) anywhere
    sass_bwd = _build.sass_ops("flash_bwd", ops=("HGMMA", "HMMA"))
    print(f"sass flash_bwd (per kernel instance): {json.dumps(sass_bwd)}", flush=True)
    for f in sass_bwd:
        if f["HMMA"] or not f["HGMMA"]:
            fail(f"flash_bwd.cu {f['function']}: {f['HGMMA']} HGMMA, {f['HMMA']} HMMA; K5 and K6 must run on wgmma")
        sass.setdefault(f["function"], []).append({k: v for k, v in f.items() if k != "function"})

    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv

    # phases 3-7 run the default configuration, whatever GN_IMPL and
    # GN_CONV_IMPL say; phases 9 and 10 switch both to pallas
    fused_gn._GN_IMPL = fused_gn_conv._IMPL = "xla"
    check_layer_norm(torch)
    fwd_rows = check_kernels(torch, fa, card)
    fwd_rows += check_kernels(torch, fa, card, TRAIN_SHAPES, with_lse=True, per="step")
    fwd_rows += [dict(r, phase=12) for r in check_kernels(torch, fa, card, CKPT_SHAPES)]
    fwd_rows += [dict(r, phase=14) for r in check_kernels(torch, fa, card, SERVE_TICK_SHAPES, per="tick")]
    fwd_rows += [dict(r, phase=14) for r in check_kernels(torch, fa, card, SERVE_DECODE_SHAPES)]
    bwd_rows = check_backward(torch, fa, card, [s for s in TRAIN_SHAPES if s[0] != "vae encode mid"])
    quality_fwd, quality_bwd = check_quality_kernels(torch, fa, card)
    fwd_rows += quality_fwd
    bwd_rows += quality_bwd
    q_rows = check_qdense(torch, card)
    i8_rows = check_int8(torch, fa, card)
    txt2img, txt2img_secs = run_pipeline(torch, fa, card_line)
    torch.cuda.empty_cache()
    turbo = run_turbo(torch, card_line)
    torch.cuda.empty_cache()
    train, train_op, train_secs, train_peak = run_train(torch, card_line)
    torch.cuda.empty_cache()
    gn_rows = check_gn(torch, card, GN_SHAPES, "request") + check_gn(torch, card, GN_TRAIN_SHAPES, "step")
    gn_rows += check_gn(torch, card, GN_ALONE_SHAPES, "gn_alone_request")
    # K3's cluster sizes: how many the card holds at once, one 227 KB CTA an
    # SM, beside what cluster_plan assumes (a shortfall costs a wave, not
    # correctness)
    stages = max(st for st in range(1, 32) if fused_gn.cluster_smem(320, 2, st) <= fused_gn.SMEM_MAX)
    full = {k: gn_clusters(16, 320, (k, 4096 // k, stages), 2) for k in (1, 2, 4, 8, 16)}
    print(f"k3 clusters at once (bf16, C 320, a full SM each): {json.dumps(full)}; cluster_plan assumes "
          f"{json.dumps(fused_gn._WAVE_CLUSTERS)}", flush=True)
    conv_rows = check_conv(torch, card, CONV_SHAPES, "request", border=True)
    conv_rows += check_conv(torch, card, CONV_TRAIN_SHAPES, "step")
    fused_txt2img = run_fused_txt2img(torch, card_line, txt2img_secs)
    torch.cuda.empty_cache()
    fused_train = run_fused_train(torch, card_line, train_op, train_secs)
    del train_op
    torch.cuda.empty_cache()
    f32 = {"fwd": check_f32_forward(torch, fa, card, SHAPES)}
    f32["fwd"] += check_f32_forward(torch, fa, card, TRAIN_SHAPES, with_lse=True, per="step")
    f32["tf32"] = check_tf32_refused(torch, fa)
    f32["bwd"] = check_f32_backward(torch, fa, card, [s for s in TRAIN_SHAPES if s[0] != "vae encode mid"])
    f32["split"] = check_f32_split(torch, fa, card)
    f32["conv"] = check_conv_f32(torch, card, CONV_F32_SHAPES, "request")
    f32["conv_split"] = check_conv_split_f32(torch, card, CONV_F32_SHAPES, "request")
    f32["qdense"] = check_qdense_f32(torch, card)
    f32["int8"] = check_int8_f32(torch, fa, card)
    with tf32(False):
        f32["gn"] = check_gn(torch, card, GN_F32_SHAPES, "fp32_request", torch.float32)
    fp32_txt2img, fp32_fused, fp32_routes = run_fp32_pipeline(torch, card_line)
    fp32_train = run_fp32_train(torch, card_line)
    torch.cuda.empty_cache()
    # phase 17 runs the command line on what phases 12 and 14-16 leave
    with build_dir("sd21_base_synthetic") as model_dir, build_dir("serving") as serve_work, \
            build_dir("phase_data") as data:
        checkpoints, ckpt_counts = run_checkpoints(torch, card_line, txt2img_secs, model_dir)
        with build_dir("idbooth_driver") as work:
            driver, driver_step_s = run_driver(torch, card_line, model_dir, work, train_secs, train_peak)
        torch.cuda.empty_cache()
        serving, serve_counts, serve_refs = run_serving(torch, card_line, model_dir, serve_work, txt2img_secs)
        torch.cuda.empty_cache()
        identity = run_identity_stack(torch, card_line, data)
        torch.cuda.empty_cache()
        quality, quality_counts = run_quality_eval(torch, card_line, data)
        torch.cuda.empty_cache()
        command_line = run_cli(torch, card_line, model_dir, serve_refs, cli_inputs(data), driver_step_s)
        torch.cuda.empty_cache()
        distribution, dist_fwd, dist_bwd = run_distribution(torch, fa, card, card_line, model_dir, txt2img_secs,
                                                            train_secs)
        fwd_rows += dist_fwd
        bwd_rows += dist_bwd
        torch.cuda.empty_cache()
        mesh_serving, mesh_fwd = run_mesh_serving(torch, fa, card, card_line, model_dir, serve_refs.get("served"))
        fwd_rows += mesh_fwd
        torch.cuda.empty_cache()
        data_parity = run_data_parity(torch, card_line, model_dir, data, txt2img_secs)
    torch.cuda.empty_cache()
    for r in fwd_rows + bwd_rows:  # phases 12's, 14's and 16's shapes: the launches their runs measured
        if r.get("phase") == 12:
            r["launches_per_request"] = ckpt_counts[r["shape"]]
        elif r.get("phase") == 14:
            r["launches_per_" + ("tick" if "launches_per_tick" in r else "request")] = serve_counts[r["shape"]]
        elif r.get("phase") == 16:
            r[next(k for k in r if k.startswith("launches_per_"))] = quality_counts[(r["kernel"], r["shape"])]
    paths = {"txt2img": txt2img, "turbo": turbo, "train": train, "fused txt2img": fused_txt2img,
             "fused train": fused_train, "fp32 txt2img": fp32_txt2img, "fp32 fused txt2img": fp32_fused,
             "fp32 routes at 2×128²": fp32_routes, "fp32 train check": fp32_train, "checkpoints": checkpoints,
             "training driver": driver, "serving and sweep": serving, "identity stack and FR (no TPU kernel)": identity,
             "quality and identity evaluation": quality, "command line": command_line,
             "distribution": distribution, "servers over a mesh": mesh_serving,
             "data layer and parity runbook": data_parity}
    launches = {n: sum(p.get(n, 0) for p in paths.values()) for n in REPLACES}
    print("launches on the main paths: " + ", ".join(f"{k} {json.dumps(v)}" for k, v in paths.items()), flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"{name} was not launched on the main paths")

    print(f"chip_smoke: all 20 phases in {time.time() - t_start:.1f} s ({card_line})", flush=True)
    print(json.dumps({"kernels": _kernel_entries(fwd_rows, bwd_rows, q_rows, i8_rows, gn_rows, conv_rows, f32,
                                                 launches, ptxas, sass)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:  # a rank of phase 18's gloo rig
        sys.exit(dist_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6],
                           *map(int, sys.argv[7:8])))
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase 19's gloo rig
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
