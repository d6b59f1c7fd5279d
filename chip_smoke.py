#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

  1. device   — require CUDA; print the card's name and power limit
                (nvidia-smi), torch and CUDA versions.
  2. build    — compile every kernel source under
                src/repro_torch/kernels/csrc with nvcc (one process per
                source, all at once), print ptxas' register/spill report,
                and require HGMMA (wgmma) in the SASS of the bf16 flash
                kernels, forward and backward, and TMA loads (UTMALDG) and
                mbarrier waits (SYNCS) in the backward's (cuobjdump -sass of
                the built libraries).
  3. kernels  — hold each kernel against its plain PyTorch version:
                kd_loss_fwd / kd_loss_bwd at the HAPFL path's row counts (4
                and 8 padded clients x batch 32), a ragged N, a ragged V in
                both dtypes, a vocabulary shape in fp32 and bf16, 13c's
                (1024, 151936) bf16 and a few such rows, (64, 151936), in
                bf16 and in fp32 (the forward's 8-block cluster), and on
                the unaligned row slice x[3:67] of a (70, 4099) bf16
                tensor (the terms and stats, fp32, at 1e-4 in both dtypes;
                bf16 gradients within one bf16 ulp of each element plus
                2^-10 of the tensor's largest |value|); two launches of
                each bitwise equal, and a row's terms, stats and gradients
                bitwise the same in an N-row call and in a call on a slice
                of those rows (the kernels pick their variant from V and
                the dtype alone); kd_loss_grad at (8, 32, 10), (4, 32,
                10), V = 777 and the vocabulary shape (4, 512, 32000) in
                fp32 and bf16, (1, 2048, 151936) bf16, a loss_chunk call's
                (1, 512, 128256) fp32 and V on either side of each switch
                of its variants (the warp kernel up to V 128, then
                clusters of 1-16 blocks a row), its fp32 gradients at
                rtol 1e-4 plus 2^-16 of the tensor's max|ref| (so that a
                slice of a row left unwritten shows), bf16 ones at the kd
                limits above, the loss means at 1e-4 and its accuracies
                exact; two launches bitwise equal, and a (C, B, V) call's
                last client bitwise a one-client call on its rows; rmsnorm
                at the serve path's (2048, 3072) and (4, 3072), a ragged N
                and an odd d; add_rmsnorm at the same
                shapes bitwise equal to `x + delta` followed by the rmsnorm
                kernel; flash_attention at the serve path's prefill shape,
                both as contiguous (B, H, S, hd) tensors and as the
                transposed views of (B, S, H, hd) tensors that the path
                gives it, a ragged S, sliding windows, hd 64 and H = KV,
                in bf16 (the wgmma kernel) and fp32 (the SIMT kernel).
                rmsnorm and flash hold fp32 to 1e-5 and 2e-5:
                tests/test_kernels.py's 2e-6 assumes the CPU's order of
                summation, and the kernels sum in another. bf16 2e-2, as
                there. The backward kernels: rmsnorm_bwd and
                add_rmsnorm_bwd (with and without g_s) at the training
                path's (2048, 3072) and (2048, 256), a ragged N and an odd
                d, in bf16 and fp32, dscale at atol tol x sqrt(N) (a sum
                over N rows in another order); flash_attention_bwd at
                (4, 24, 8, 512, 128) and the lite's (4, 4, 4, 512, 64),
                S = 300, window 64 and 48, fp32 and bf16, both layouts.
                Two backward launches must be bitwise equal, and the flash
                forward's o the same bits with and without its lse; the
                norm backward, one launch, must replay under a CUDA graph
                bit for bit as it runs eagerly.
                qwen3-moe-30b-a3b's shapes (phases 5c and 9c) come first
                too: rmsnorm and add_rmsnorm at (2048, 2048) and (4,
                2048), their backwards at (2048, 2048), bf16 and fp32;
                flash at (4, 32, 4, 512, 128), 32 heads over 4 KV heads,
                both dtypes and layouts, and the 2-layer parity cut's (2,
                32, 4, 128, 128) fp32; its backward at (4, 32, 4, 512,
                128) bf16; kd_loss_grad at (1, 2048, 151936) fp32.
                So do qwen2-vl-2b's and musicgen-medium's (phases 5e-5g,
                9d, 9e): the norms and their backwards at (2048, 1536) and
                (4, 1536), bf16 and fp32; flash at (4, 12, 2, 512, 128), a
                group of 6, and (4, 24, 24, 512, 64), H = KV at hd 64,
                forward and backward, both dtypes and layouts;
                kd_loss_grad at (1, 8192, 2048) and (1, 8192, 2049), off
                16 bytes, fp32 and bf16. And the SSM family's (phases 5h,
                9f, 9g): kd_loss_grad at xlstm-1.3b's (1, 2048, 50304) and
                zamba2-7b's (1, 2048, 32000), fp32. And zamba2-7b's norm
                and flash shapes at full width (phase 9g): rmsnorm and
                add_rmsnorm at (2048, 3584) and (4, 3584), their backwards
                at (2048, 3584), bf16 and fp32 (its pure-Mamba2
                LiteModel's (2048, 256) are the llama LiteModel's); flash
                and its backward at hd 112, which the kernels run on hd
                128's tiles: (4, 32, 32, 512, 112), S 300, window 64 and a
                group of 4 ((2, 8, 2, 256, 112)), both dtypes and layouts,
                and the hd-112 parity cut's (2, 2, 2, 128, 112) fp32.
  3b. adamw   — the optimizer's kernels (csrc/adamw.cu) over each
                benchmark train cell's whole leaf set (shapes from the
                configuration files under portbench/configs/: the MoE
                cut's 25 leaves, 3.19 B parameters, and qwen2-vl's 22,
                1.79 B), seeded, one step: the fused update's p, m and v
                bitwise the plain adamw_plain_'s given the plain norm's
                clip factor, the
                kernels' norm within 1e-5 of a float64 one and the same
                bits twice, exactly 1 sumsq, 1 sumsq_finish and 1 adamw
                launch a step, and each kernel's device ms from CUDA-graph
                replays beside its byte bound (22 B a bf16 parameter for
                the update, 2 for the norm) and its plain version's ms.
  3c. decode  — the decode attention (csrc/decode_attention.cu) at every
                config's decode shape (hd 64/112/128/224, G 1/3/4/6/8/48;
                bf16 at the serve paths' B 4, L 1024, fp32 at B 2, L 256)
                and both serve cells' ((32, 32, 4, 1024, 128) and (32, 32,
                32, 1024, 224), bf16), each at kv_valid 1, 545 (or L / 2),
                L and a ring wrapped past L: max|err| against float64 at
                most TOL_DECODE and at most the plain version's (or
                DECODE_FLOOR), two launches bitwise; graph replays at
                every position == eager launches bitwise; device ms at the
                cells' shapes at 545 filled slots beside the byte bound,
                the plain version and SDPA over the filled slots. Every
                serve phase then counts one decode_attention launch an
                attention call a step, finds no copy of a cache-sized
                tensor in two eager decode steps, and 9h's profiled
                generate runs each decode-attention kernel 13 x 64 times.
  4. HAPFL    — Algorithm 1 on the paper's cifar10 pool at full width
                (small + large CNNs, 10 clients, 6 per round): 10
                latency-only PPO pretraining rounds, then 3 training rounds
                through the batched engine. Launch counters are zeroed just
                before and read just after: kd_loss_grad must have launched
                exactly once per padded step of every size group, and
                kd_loss_fwd / kd_loss_bwd never. A shape the path gave the
                kernel that phase 3 did not check is checked now.
  4b. baselines — FedAvg, FedProx, pFedMe and FedDdrl (paper §V.B) at the
                same config through BaselineRunner on the card: 2 training
                rounds each (FedDdrl after 5 latency-only rounds, so that
                its PPO2 updates), seconds per round, acc_global and
                summary() logged, every global finite and no kernel
                launched (their loss is plain CE, no kd_loss). Then one
                FedProx and one pFedMe round on the card and on the CPU from
                the same globals: identical host records (clients,
                straggling, wall time), globals at atol 1e-4 / rtol 1e-3.
  4c. async   — examples/comm_efficient.py's setup at the same config: a
                HAPFL server with cross-size aggregation and the topk+int8
                codec (ratio 0.08, dense_min 256) under
                EventScheduler(BufferedPolicy(buffer_m=3)) with
                codec-priced links, fleet health and the tracer on, 4
                waves. Counters are zeroed just before and read just after:
                one kd_loss_grad per padded step of every wave; every
                wave's record carries rl_diag; each upload is under a
                quarter of its dense float32 bytes; the first aggregation
                moves both sizes' globals (small does not cover large, so
                the coverage-class path runs); globals finite. Then
                codec="identity" equals codec=None bit for bit for a round,
                and EventScheduler(SyncPolicy()).run(waves=2) equals
                server.run(2) (records, and globals bit for bit). The wall
                time of both phases is logged, and of the whole script.
  4d. service — the parameter service at launch/serve.py's defaults
                (mnist, 16 clients, k 4, async, churn, 400 Poisson events
                at 2 Hz) with the topk+int8 codec: serve.main into a
                temporary directory with --checkpoint-dir, --health-report,
                --prom-out and --events-jsonl, then a second main on the
                same directory, which must resume. Then the kill/restore
                pin of the buffered service, identity and topk+int8: one
                run replays the whole trace; another replays to event 200,
                checkpoints and is dropped; a fresh service restores and
                replays the rest, and must equal the first bit for bit
                (globals, LiteModel, both PPO agents, the generator, EF
                residuals, env rng, records, counters, bytes). Updates/s,
                dispatch and submit latency, checkpoint time and bytes,
                wire over dense bytes, a cProfile of a replay and its
                device busy share are logged; every kernel's launch count
                must stay 0 (the service trains nothing).
  5. serve    — llama3.2-3b at full width (28 layers, d 3072, 24 heads, 8
                KV heads, vocab 128256) in bf16, random weights from a
                seeded generator on the card: ServeEngine(max_len=1024)
                .generate on 4 prompts x 512 tokens for 32 new tokens; the
                decode step is captured into a CUDA graph at the engine's
                first generate and replayed. Counters are zeroed just
                before the counted generate and read just after: rmsnorm
                1 + 32 = 33, add_rmsnorm (2 * 28) * (1 + 32) = 1848,
                flash_attention 28, kd 0. The graphed generate's tokens
                and each step's logits must equal, bit for bit, an eager
                loop of make_decode_step on the card from the same
                prefill; so must a 2-layer sliding-window cut whose ring
                buffer wraps under the graph. Prefill ms, decode ms per
                step graphed and eager, the graph replay's device ms per
                step, tokens/s and peak memory are printed.
  5c. moe serve — phase 5 on qwen3-moe-30b-a3b at full width and depth (48
                layers, d 2048, 32 heads over 4 KV heads, hd 128, 128
                experts, top-8, moe_d_ff 768, vocab 151936, untied), bf16,
                seeded weights drawn on the card after phase 5's engine is
                freed (the free memory before init is logged): rmsnorm 33,
                add_rmsnorm 2 * 48 * 33 = 3168, flash_attention 48 launches,
                no other kernel; graphed == eager bit for bit; the times,
                peak memory, the prefill's dropped_frac a layer, the decode
                step's byte bound (the reference's capacity dispatch runs
                every expert at every step) and a profiled graphed decode
                loop. Its norm and flash shapes are timed as in phase 6.
  5d. moe parity — a 2-layer fp32 cut of it, the same weights on the card
                and on the CPU: prefill and 4 decode steps' logits at atol
                and rtol 1e-3 with every layer's expert indices equal (a
                mismatch names the token, the layer and its k-th / (k+1)-th
                router probability gap; the least gap is logged), then one
                loss_and_grads with its LiteModel: loss, lb_loss, metrics,
                grad norm and the gradients of layer 0's router, w_up,
                w_down and the embedding at 1e-3, routes equal again.
  5e. vlm serve — phase 5 on qwen2-vl-2b at full width and depth (28
                layers, d 1536, 12 heads over 2 KV heads, hd 128, d_ff
                8960, vocab 151936, untied, M-RoPE sections (16, 24, 24)),
                bf16, seeded weights, after phase 9c's state is freed (the
                free memory is logged first): 4 x 512 N(0, 1) patch
                embeddings from a seeded generator with (t, t // 8, t % 8)
                positions; each decode step gathers its argmax tokens'
                embedding rows inside the graph. rmsnorm 33, add_rmsnorm
                1848, flash_attention 28 launches, no other kernel;
                graphed == eager bit for bit; the times, peak memory, the
                decode step's byte bound and a profiled graphed decode
                loop.
  5f. audio serve — the same on musicgen-medium (48 layers, d 1536, 24
                heads = KV heads, hd 64, d_ff 6144, GELU, layernorm, 4
                codebooks over vocab 2048): (4, 512, 4) codebook tokens, a
                (4, 32, 4) result; 0 norm and 48 flash launches; the byte
                bound counts the 1.21 GB KV cache at max_len 1024.
  5g. vlm / audio parity — a 2-layer fp32 cut of each at full width, the
                same weights on the card and on the CPU: prefill and 4
                decode steps' logits at atol and rtol 1e-3; one
                loss_and_grads with its LiteModel: loss, metrics, grad norm
                and the gradients of layer 0's wq, the norm params and the
                embedding tables at 1e-3; the VLM's embedding gradient
                exactly zero on both sides.
  5h. ssm serve — phase 5 on xlstm-1.3b at full width and depth (48
                layers: 6 groups of 7 mLSTM blocks and one sLSTM block, d
                2048, 4 heads, vocab 50304, layernorm, tied; 1.664 B
                parameters, 3.380 GB), bf16 with fp32 gates, recurrent
                weights and states, seeded weights, after phase 9e's state
                is freed: exactly 0 rmsnorm, add_rmsnorm and flash launches
                (layernorm, no attention); graphed == eager bit for bit
                (the decode step writes every recurrent state back into the
                graph's static cache in place); the times, peak memory and
                the decode step's byte bound, which counts the 1.411 GB of
                recurrent state twice (read and written every step); one
                prefill with its sLSTM blocks timed (their Python loop of
                512 steps each: the share of the prefill); a profiled
                graphed decode loop.
  5i. ssm / hybrid parity — a 2-layer fp32 cut of xlstm-1.3b at full width
                with slstm_every 2 (one mLSTM and one sLSTM block; the
                config's own 2-layer cut would be mLSTM only) and zamba2-
                7b's smoke cut (2 Mamba2 blocks and the shared attention
                block at hd 64) and its hd-112 cut (zamba2-7b with 2
                layers, d 224 over 2 heads = 2 KV heads, shared_attn_every
                2: the fp32 SIMT flash kernels, forward and backward, at hd
                112 through the whole model), the same weights on the card
                and on the CPU: prefill and 4 decode steps from the
                prefill's whole cache, logits and every cache leaf at atol
                and rtol 1e-3; one loss_and_grads with its LiteModel: loss,
                metrics, grad norm and every gradient at 1e-3.
  6. timing   — each kernel, its plain version and, where one PyTorch call
                computes the same function, that call (F.rms_norm,
                x + delta then F.rms_norm, F.scaled_dot_product_attention),
                at every shape and layout its path gave it. `ms` is device
                time: the calls are captured into one CUDA graph and its
                replay is timed with CUDA events, so the host's issue cost
                is left out. For the norms and flash the calls cycle over
                copies of their inputs that together spill
                the 50 MB L2, so that each call reads device memory, as the
                bound assumes; `warm_ms` reuses one copy. `eager_ms` is the
                wall time per call of back-to-back eager calls, the
                wrapper's host cost included. kd_loss_fwd / kd_loss_bwd
                are timed the same way, L2-cold, at the HAPFL path's rows,
                (2048, 32000) in both dtypes, 13c's (1024, 151936) bf16 and
                the few rows (64, 151936) bf16, each with its share of its
                bound.
  7. parity   — with PPO off and the same starting globals, one ragged
                cohort trained on the card (through the kernels) equals the
                same cohort trained on the CPU (plain versions); a 2-layer
                cut of the full-width llama in fp32 gives the same prefill
                logits and 4 decode steps' logits on the card and on the
                CPU (atol and rtol 1e-3).
  8. profile  — one more HAPFL training round, one more generate, its
                graphed decode loop alone and one prefill under
                torch.profiler: device time by kernel, the device's busy
                share, and the idle gaps between the decode loop's device
                work. The prefill must make no layout copy (aten::clone)
                of q, k, v or the attention output around the flash
                kernel.

  9. train    — llama3.2-3b at full width (bf16, remat) with its LiteModel
                through repro_torch.launch.train's functions: batch 4 x
                seq 512 of make_token_dataset tokens, AdamW at
                TrainStepConfig()'s defaults; a warm step, then 3 counted
                steps with exact launch counts derived from the config
                (train_launch_shapes: with remat each block's kernels run
                twice forward; optimizer_launches: the optimizer's sumsq,
                sumsq_finish and adamw a step, from the leaves), finite
                loss and grad norm; seconds per
                step, tokens/s, peak memory; one more step under
                torch.profiler.
  9c. moe train — phase 9 on qwen3-moe-30b-a3b at full width cut to 4 of
                its 48 layers (AdamW's 12 B a parameter: 366 GB for all of
                it), bf16, remat, with its dense LiteModel, AdamW at
                TrainStepConfig()'s defaults (moe_aux_coef 0.01, z_loss_coef
                1e-3): exact launches from the config, finite loss, grad
                norm and lb_loss, seconds a step, tokens/s, peak memory; one
                profiled step names the MoE operators' device time (bmm,
                index_add, index_select, topk, cumsum). It runs after phase
                9b's state is freed; its backward and kd_loss_grad shapes
                are timed as in phase 12.
  9d. vlm train — phase 9 on qwen2-vl-2b at full width and depth with its
                LiteModel (2 layers, d 1536, d_ff 512), on dummy_batch's
                patch embeddings: exact launches, finite loss and grad
                norm, seconds a step, tokens/s, peak memory, one profiled
                step. 9e. audio train — the same on musicgen-medium and its
                LiteModel on codebook tokens: no norm launch, kd_loss_grad
                on (1, B S 4, 2048); tokens/s counts token positions.
                Both run after 5e-5g; their backward and kd_loss_grad
                shapes are timed as in phase 12, their forward shapes as in
                phase 6.
  9f. ssm train — phase 9 on xlstm-1.3b at full width and depth (bf16,
                remat: each mLSTM block under checkpoint, the sLSTM not, as
                in the reference) with its LiteModel (2 mLSTM blocks, d
                256): exactly 1 kd_loss_grad launch a step at (1, 2048,
                50304) and no other kernel; finite loss and grad norm,
                seconds a step, tokens/s, peak memory, one profiled step,
                and the 6 sLSTM blocks timed forward and backward alone at
                the step's shapes (their share of the step). After 5h-5i.
  9g. hybrid   — zamba2-7b at full width and depth (81 Mamba2 layers in
                13 segments of 6, each followed by the one shared attention
                + MLP block, and a tail of 3; d 3584, 32 heads = KV heads,
                hd 112, d_ff 14336, ssm_state 64, vocab 32000; 6.75 B
                parameters, 13.5 GB) in bf16, seeded weights, after 9f's
                state is freed, served as in phase 5: rmsnorm 1 + 32,
                add_rmsnorm 106 at (2048, 3584) and 1 + 32 x 107 at (4,
                3584) (107 block norms: 81 + 2 x 13), flash 13 at (4, 32,
                32, 512, 112) a generate; graphed == eager bit for bit;
                the times, peak memory and the decode byte bound, which
                counts the shared block's weights at each of its 13
                invocations (and logs the bound with them counted once);
                a profiled graphed decode loop. Then trained at full width
                on 12 of its layers (two segments, no tail), bf16, remat
                (each segment under one checkpoint), with its pure-Mamba2
                LiteModel (2 blocks, d 256; remat too), as in phase 9,
                a step: rmsnorm 2 + 2 and add_rmsnorm 31 + 3 at (2048,
                3584) + (2048, 256), their backwards 1 + 1 and 16 + 2, flash
                4 and its backward 2 at (4, 32, 32, 512, 112) (two
                segments, each run twice forward under remat), and
                kd_loss_grad 1 at (1, 2048, 32000); finite loss and grad
                norm, seconds a step, tokens/s, peak memory, one profiled
                step.
  9b. ckpt     — phase 9's trained params saved with save_checkpoint (as
                launch/train.py --checkpoint does) under a temporary
                directory and restored onto the card with
                load_checkpoint(like=...): every leaf bitwise equal (bf16
                through its 16-bit view); free space, bytes, save and load
                seconds logged. One forward of the local model on the
                training batch from the restored and from the live params:
                bitwise-equal logits, exactly 1 rmsnorm, 2 L add_rmsnorm
                and L flash_attention launches each, no other kernel.
 10. fleet    — two LLMFleet rounds on the card (one kd_loss_grad per
                local step).
 11. parity   — one train step of a 2-layer fp32 cut of the full-width
                llama on the card and on the CPU (loss, metrics, grad norm,
                the grads of wq, the norm scales and the embedding, at
                1e-3), and one fleet round with injected sizes and
                intensities.
 12. timing   — the backward kernels at the training path's shapes beside
                their bounds, plain versions and the library's backward
                alone (F.rms_norm's; SDPA's with enable_gqa); the norm
                backward's and flash backward's device time by kernel (the
                norm backward must be one kernel); the flash forward with
                and without lse; kd_loss_grad at (1, 2048, 128256) fp32.
 13. sharded  — the mesh-sharded path over torch.distributed (one card, so
                no scaling is measured). 13a: a one-rank NCCL group in this
                process; phase 4's config, 3 rounds of engine="sharded"
                against engine="batched" from seed 0: equal sizes and
                intensities, bitwise-equal globals, equal kd_loss_grad
                launches, seconds a round. 13b-13d: ranks spawned on the one
                card under gloo (NCCL refuses two ranks on a device), which
                load the libraries phase 2 built. 13b, world 2: one round
                of the same config with each engine from seed 0: equal
                sizes and intensities, both ranks' globals bitwise equal,
                each rank's kd_loss_grad launches one a padded step of its
                share (C_p / 2) of every group; the distance to the batched
                engine's globals is logged beside the batched engine's own
                distance between its padded and its exact client count on
                that cohort (the card's GEMMs round differently at another
                client count, and 40+ SGD steps grow it past 1e-4); two
                cohorts sharded against batched at atol 1e-5 / rtol 1e-4:
                the reference's MESH_PARITY cohort (tests/test_sharded.py:
                1-3 epochs, one-client groups) and four clients in one
                group, so that each rank trains two real clients.
                13c, world 2: sharded_kd_loss at
                (2048, 151936), sharded_rmsnorm at (2048, 3584),
                sharded_flash_attention at (4, 32, 32, 512, 112) and (4,
                24, 8, 512, 128), bf16, each bitwise equal to the unsharded
                kernel on the whole tensor, one launch a rank, and that
                kernel within phase 3's bf16 tolerance of its plain
                version. 13d, world 4:
                flash_decode_sharded at qwen2-vl-2b's decode shape (B 4, H
                12, KV 2, hd 128, L 32768, the slot in the third slice)
                against gqa_attention over the whole cache (fp32 1e-5, bf16
                2e-3), the new k/v in exactly one rank's slice; a 2-layer
                fp32 cut of qwen2-vl-2b at full width, prefill and 16
                decode steps through models.api on a (1, 4) mesh against no
                mesh, logits at 1e-4; every launch equal but the decode
                attention's, once a layer a step without the mesh and
                never on it (the sharded decode is plain PyTorch). 13e: the grouped MoE dispatch, a
                2-layer fp32 cut of qwen3-moe-30b-a3b at full width, the
                blocks' forward at G = 2 and 4 on the card and on the CPU:
                equal routes and kept pairs at every MoE call, y at 1e-3.
 14. launch   — the launch tooling (repro_torch.launch: specs, sharding,
                dryrun). 14a: each path served or trained above (phases 5,
                5c, 5e, 5f, 5h, 9, 9c-9g) dry-run on the meta device at its
                own config and shapes (prefill and decode for a serve
                path, one step for a train path): the kernel calls the dry
                run counts (a generate: one prefill's plus n_new decode
                steps'; training: a step's times the steps) must equal the
                launches the card counted on that path; beside each
                measured time, compute_s, memory_s, the roofline share
                max(compute_s, memory_s) / measured and the mfu, model
                FLOPs / (measured s x 989 TFLOP/s); it runs on the host
                while 14b's first world runs. 14b: gloo ranks on the
                one card at worlds 2 and 4, llama3.2-3b at full width (1
                layer): its bf16 params, its AdamW state and a decode cache
                sharded on a (1, w) and a (w, 1) mesh by the FSDP x TP
                rules and gathered back, bitwise; each rank's bytes equal
                the specs' sum; the gathers collective_stats reads equal
                the formula's. 14c: mixtral-8x7b's bytes a card from the
                specs on the production node mesh (1, 8).

The parity phases turn TF32 off for cuDNN and matmuls, so that both sides
compute in full float32, and restore the defaults afterwards.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without CUDA, or run outside a checkout of
the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's datasheet rates the bounds divide by (bytes / s, fp32 and bf16
# operations / s): repro_torch.kernels.cost.HW, copied in by main()
HW = {}
L2_BYTES = 50e6                 # H100 L2 cache
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# kd_loss_fwd / kd_loss_bwd against their plain versions, tensor by tensor:
# an fp32 output (terms, stats, fp32 gradients) within TOL["float32"] for
# either logits dtype, since both sides compute it in fp32 from the same
# values; a bf16 gradient, which both sides round from fp32, within one bf16
# ulp of each element (rtol 2^-7) plus 2^-10 of the tensor's largest |value|
KD_BF16_RTOL = 2.0 ** -7
KD_BF16_ATOL_SHARE = 2.0 ** -10
KD_TOL_TEXT = "fp32 1e-4; bf16 2^-7 |ref| + 2^-10 max|ref|"
# kd_loss_grad's fp32 gradients: rtol 1e-4 plus 2^-16 of the tensor's
# largest |value|. At B = 2048 an entry off the label is about (0.4 / 2048)
# p, far below an absolute 1e-4, so only a limit relative to the tensor's
# scale sees a slice of a row left unwritten. bf16 gradients at the
# KD_BF16_* limits, the four loss means at 1e-4, the accuracies exact.
KD_GRAD_ATOL_SHARE = 2.0 ** -16
KD_GRAD_TOL_TEXT = ("fp32 1e-4 |ref| + 2^-16 max|ref|; bf16 2^-7 |ref| + "
                    "2^-10 max|ref|; means 1e-4")
TOL_NORM = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2e-2}
TERMS = ("ce_x", "ce_y", "kl_xy", "kl_yx")
# the main path calls kd_loss on C*B logit rows: C is a size group's client
# count padded to a power of two, at least 4; 6 clients per round give
# groups of 4 or 8 padded clients, at batch 32
# kd_loss_grad (C, B, V, dtype): the path's two group shapes, a ragged V
# and the vocabulary shape the LLM training slice will give it
GRAD_SHAPES = [(8, 32, 10, "float32"), (4, 32, 10, "float32"),
               (2, 32, 777, "float32"), (2, 32, 777, "bfloat16"),
               (4, 512, 32000, "float32"), (4, 512, 32000, "bfloat16"),
               (1, 2048, 128256, "float32"), (1, 2048, 151936, "float32"),
               (1, 2048, 151936, "bfloat16"),
               # a train/step.py loss_chunk call's rows
               (1, 512, 128256, "float32"),
               # musicgen-medium's 4 x 512 x 4 codebook rows at V 2048, and
               # V 2049, off 16 bytes (scalar staging)
               (1, 8192, 2048, "float32"), (1, 8192, 2048, "bfloat16"),
               (1, 8192, 2049, "float32"), (1, 8192, 2049, "bfloat16"),
               # xlstm-1.3b's 4 x 512 rows at V 50304, and zamba2-7b's at
               # V 32000
               (1, 2048, 50304, "float32"), (1, 2048, 32000, "float32")]
# kd_loss.cu's kPairSlice, a row block's bytes of a row pair at most:
# kd_loss_grad's cluster doubles where a row pair passes 1, 2, 4 and 8 of
# them; phase_kd_grad checks this value against the source
KD_PAIR_SLICE = 110592
# either side of each switch of kd_loss_grad's variants: the warp kernel up
# to V 128, then the row kernel's cluster of 1, 2, 4, 8 and 16 blocks, each
# at its last V and one 16-byte unit past it; and the scalar path (V off
# 16 bytes) one element past each cluster switch and at the widest V
GRAD_SWITCH_SHAPES = [
    (2, 8, V, dtype) for dtype, elt in (("float32", 4), ("bfloat16", 2))
    for last in [KD_PAIR_SLICE * cl // (2 * elt) for cl in (1, 2, 4, 8)]
    for V in (last, last + 16 // elt, last + 1)] + [
    (2, 8, V, dtype) for dtype in ("float32", "bfloat16")
    for V in (128, 136, 151937)]
GRAD_VOCAB = [(4, 512, 32000, "float32"), (4, 512, 32000, "bfloat16")]
LAMBDAS = (0.4, 0.6, 0.5, 0.5)
CHECK_SHAPES = [(128, 10, "float32"), (256, 10, "float32"),
                (1000, 10, "float32"), (64, 777, "float32"),
                (64, 777, "bfloat16"), (2048, 32000, "float32"),
                (2048, 32000, "bfloat16"), (1024, 151936, "bfloat16"),
                (64, 151936, "bfloat16"),
                # fp32 rows that take the forward's 8-block cluster
                (64, 151936, "float32")]
# kd_loss_fwd / kd_loss_bwd timed beyond the path's rows: the vocabulary
# shape in both dtypes, 13c's rank rows and a few such rows
VOCAB_SHAPES = [(2048, 32000, "float32"), (2048, 32000, "bfloat16"),
                (1024, 151936, "bfloat16"), (64, 151936, "bfloat16")]
# bitwise checks of kd_loss_fwd / kd_loss_bwd (N, V, dtype, rows): two
# launches equal, and rows [a, b) of an N-row call equal to a call on the
# slice x[a:b] (13c's rank half; a few rows; an unaligned V)
KD_BITWISE = [(1024, 151936, "bfloat16", (512, 1024)),
              (1024, 151936, "bfloat16", (1, 65)),
              (2048, 32000, "float32", (5, 69)),
              (2048, 32000, "bfloat16", (1000, 1100)),
              (64, 777, "bfloat16", (3, 40)),
              (70, 4099, "bfloat16", (3, 67)),
              (256, 10, "float32", (128, 256))]

# the serve path: llama3.2-3b at full width, 4 prompts x 512 tokens, 32 new
SERVE = {"arch": "llama3.2-3b", "batch": 4, "prompt": 512, "n_new": 32,
         "max_len": 1024, "seed": 0}
# its sliding-window cut: 2 layers, a 64-slot ring buffer that 40 decode
# steps after a 48-token prompt wrap around
WRAP = {"n_layers": 2, "window": 64, "prompt": 48, "n_new": 40}
# rmsnorm (N, d, dtype) and flash (B, H, KV, S, hd, window, dtype, layout)
# checks; layout "bshd" is the transposed view of (B, S, H, hd) tensors that
# the model passes, "bhsd" contiguous (B, H, S, hd) tensors
NORM_SHAPES = [(2048, 3072, "bfloat16"), (4, 3072, "bfloat16"),
               (2048, 256, "bfloat16"),
               (2048, 3072, "float32"), (4, 3072, "float32"),
               (1000, 3072, "bfloat16"), (1000, 3072, "float32"),
               (64, 777, "float32"), (64, 777, "bfloat16"),
               # qwen3-moe-30b-a3b: prefill and training, decode
               (2048, 2048, "bfloat16"), (4, 2048, "bfloat16"),
               (2048, 2048, "float32"), (4, 2048, "float32"),
               # qwen2-vl-2b: prefill and training, decode
               (2048, 1536, "bfloat16"), (4, 1536, "bfloat16"),
               (2048, 1536, "float32"), (4, 1536, "float32"),
               # zamba2-7b at full width: prefill and training, decode
               (2048, 3584, "bfloat16"), (4, 3584, "bfloat16"),
               (2048, 3584, "float32"), (4, 3584, "float32")]
# flash at hd 112, forward and backward: zamba2-7b's (4, 32, 32, 512, 112),
# S 300, window 64 and a group of 4, both dtypes and layouts
HD112_SHAPES = [(B, H, KV, S, 112, w, dt, lay)
                for B, H, KV, S, w in ((4, 32, 32, 512, 0), (2, 4, 4, 300, 0),
                                       (1, 4, 4, 256, 64), (2, 8, 2, 256, 0))
                for dt in ("bfloat16", "float32") for lay in ("bshd", "bhsd")]
FLASH_SHAPES = [(4, 24, 8, 512, 128, 0, "bfloat16", "bshd"),
                (4, 24, 8, 512, 128, 0, "float32", "bshd"),
                (4, 24, 8, 512, 128, 0, "bfloat16", "bhsd"),
                (4, 24, 8, 512, 128, 0, "float32", "bhsd"),
                (2, 24, 8, 300, 128, 0, "bfloat16", "bshd"),
                (2, 24, 8, 300, 128, 0, "float32", "bhsd"),
                (2, 8, 2, 512, 128, 64, "float32", "bhsd"),
                (2, 8, 2, 512, 128, 64, "bfloat16", "bshd"),
                (1, 4, 2, 300, 128, 100, "bfloat16", "bhsd"),
                (2, 8, 4, 256, 64, 0, "float32", "bhsd"),
                (2, 8, 4, 256, 64, 0, "bfloat16", "bshd"),
                (2, 8, 4, 300, 64, 48, "bfloat16", "bhsd"),
                (2, 8, 8, 256, 128, 0, "float32", "bhsd"),
                (2, 8, 8, 256, 128, 0, "bfloat16", "bhsd"),
                (4, 4, 4, 512, 64, 0, "bfloat16", "bshd"),
                # qwen3-moe-30b-a3b: 32 heads over 4 KV heads, a group of 8
                (4, 32, 4, 512, 128, 0, "bfloat16", "bshd"),
                (4, 32, 4, 512, 128, 0, "float32", "bshd"),
                (4, 32, 4, 512, 128, 0, "bfloat16", "bhsd"),
                (4, 32, 4, 512, 128, 0, "float32", "bhsd"),
                (2, 32, 4, 128, 128, 0, "float32", "bshd"),
                # qwen2-vl-2b (and its LiteModel): 12 heads over 2 KV heads,
                # a group of 6; musicgen-medium: H = KV = 24 at hd 64
                *[(4, H, KV, 512, hd, 0, dt, lay)
                  for H, KV, hd in ((12, 2, 128), (24, 24, 64))
                  for dt in ("bfloat16", "float32")
                  for lay in ("bshd", "bhsd")],
                # zamba2-7b's shared block at full width, H = KV = 32 at hd
                # 112 (the kernels pad it to hd 128's tiles), a ragged S, a
                # window and a group of 4 at hd 112; the fp32 parity cut's
                *HD112_SHAPES, (2, 2, 2, 128, 112, 0, "float32", "bshd")]

# the training path: llama3.2-3b at full width (bf16, remat, the config's
# own) with its LiteModel, batch 4 x seq 512, AdamW at TrainStepConfig()'s
# defaults; one warm step, then TRAIN["steps"] counted and timed ones
TRAIN = {"arch": "llama3.2-3b", "batch": 4, "seq": 512, "steps": 3,
         "seed": 0}
# the MoE paths: qwen3-moe-30b-a3b served at full width and depth (SERVE's
# batch, prompt and new tokens), a 2-layer fp32 cut of it on the card
# against the CPU, and trained at full width on 4 of its 48 layers (TRAIN's
# batch and steps): AdamW's 12 B a parameter makes the whole 30.5 B
# parameters 366 GB of training state, the 4-layer cut's 3.1 B about 37 GB
MOE = {"arch": "qwen3-moe-30b-a3b", "parity_layers": 2, "train_layers": 4}
# the MoE routed FFN's own operators, whose device time phase 9c's profile
# names (the expert products, the dispatch scatter and the combine gather,
# forward and backward, and the routing's top-k and position count)
MOE_OPS = ("aten::bmm", "aten::index_add", "aten::index_add_",
           "aten::index_select", "aten::topk", "aten::cumsum")
# the VLM and audio paths (phases 5e-5g, 9d, 9e): qwen2-vl-2b and
# musicgen-medium served and trained at full width and depth (SERVE's and
# TRAIN's sizes; the VLM on seeded patch embeddings with (t, t // 8, t % 8)
# M-RoPE positions, audio on (B, S, 4) codebook tokens), and 2-layer fp32
# cuts of each on the card against the CPU
VLM_AUDIO = {"archs": ("qwen2-vl-2b", "musicgen-medium"), "parity_layers": 2}
# the SSM paths (phases 5h, 5i, 9f, 9g): xlstm-1.3b served and trained at
# full width and depth (SERVE's and TRAIN's sizes); on the card against the
# CPU in fp32, a 2-layer full-width xlstm cut whose second block is its
# sLSTM (slstm_every 2: the config's own 2-layer cut would be mLSTM only),
# zamba2-7b's smoke cut and a cut of it at its head dim (2 layers, one
# segment, d 224 over 2 heads: hd 112, the fp32 SIMT flash kernels through
# the whole model); zamba2-7b in bf16 served at full width and depth and
# trained at full width on 12 of its 81 layers (two segments, so that the
# shared block's gradient sums over two invocations as in the whole model;
# AdamW's 12 B a parameter would make all 6.75 B about 81 GB of state)
SSM = {"arch": "xlstm-1.3b", "parity_cut": {"n_layers": 2, "slstm_every": 2},
       "hybrid": "zamba2-7b", "train_layers": 12,
       "hd112_cut": {"n_layers": 2, "d_model": 224, "n_heads": 2,
                     "n_kv_heads": 2, "shared_attn_every": 2}}
# Zamba2-7B-Instruct as published (phase 9h), whole in bf16 at the
# benchmark cell zamba2-serve's shapes: 32 prompts of 512 tokens, 64 new
# tokens, max_len 1024, the prompt's recurrent state carried into the
# graphed decode; its hd-224 flash at the prefill's shape and the config's
# scale (hd / 2)^-0.5
ZAMBA2 = {"arch": "zamba2-7b-instruct", "batch": 32, "prompt": 512,
          "n_new": 64, "max_len": 1024, "seed": 0}
# backward checks: norms (N, d, dtype), flash as FLASH_SHAPES
NORM_BWD_SHAPES = [(2048, 3072, "bfloat16"), (2048, 3072, "float32"),
                   (2048, 256, "bfloat16"), (2048, 256, "float32"),
                   (1000, 3072, "bfloat16"), (1000, 3072, "float32"),
                   (64, 777, "float32"), (64, 777, "bfloat16"),
                   (2048, 2048, "bfloat16"), (2048, 2048, "float32"),
                   (2048, 1536, "bfloat16"), (2048, 1536, "float32"),
                   (2048, 3584, "bfloat16"), (2048, 3584, "float32")]
FLASH_BWD_SHAPES = [(4, 24, 8, 512, 128, 0, "bfloat16", "bshd"),
                    (4, 24, 8, 512, 128, 0, "float32", "bshd"),
                    (4, 4, 4, 512, 64, 0, "bfloat16", "bshd"),
                    (2, 24, 8, 300, 128, 0, "bfloat16", "bshd"),
                    (2, 8, 2, 512, 128, 64, "bfloat16", "bshd"),
                    (2, 8, 2, 512, 128, 64, "float32", "bhsd"),
                    (2, 8, 4, 300, 64, 48, "float32", "bshd"),
                    # grids of two blocks an SM or more: one dQ consumer
                    (4, 24, 8, 300, 128, 64, "bfloat16", "bshd"),
                    (8, 16, 4, 300, 64, 48, "bfloat16", "bhsd"),
                    (4, 32, 4, 512, 128, 0, "bfloat16", "bshd"),
                    *[(4, H, KV, 512, hd, 0, dt, lay)
                      for H, KV, hd in ((12, 2, 128), (24, 24, 64))
                      for dt in ("bfloat16", "float32")
                      for lay in ("bshd", "bhsd")],
                    *HD112_SHAPES]

def _cost():
    """The kernels' work formulas and bounds, which the dry run reads too:
    one source, `repro_torch.kernels.cost` (importable once main() has put
    src/ on the path)."""
    from repro_torch.kernels import cost
    return cost


def free_device_memory(torch):
    """Collect what the caller dropped (reference cycles included) and hand
    the allocator's cached blocks back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def full_fp32(torch):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------------- #
# 1-2. device and build
# ---------------------------------------------------------------------- #
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s in all, per source "
        f"{ {k: round(v, 2) for k, v in per_source.items()} }")
    for name, report in _build.reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[build] {name}: {line.strip()}")
    check_hgmma(_build)


def check_hgmma(_build):
    """The bf16 flash kernels must run on the tensor cores through wgmma,
    fed by TMA: the forward's flash_wgmma_kernel and the backward's
    flash_bwd_dkdv_wgmma_kernel and flash_bwd_dq_wgmma_kernel are
    instantiated for every head dim of HEAD_DIMS (112 included: its
    mangled name carries ILi112E), the forward's also for FWD_HEAD_DIMS
    (224), and every instantiation has HGMMA in
    its SASS, the backward's also UTMALDG (cp.async.bulk.tensor) and SYNCS
    (mbarrier) instructions."""
    from repro_torch.kernels.flash_attention import FWD_HEAD_DIMS, HEAD_DIMS
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    wanted = {"flash_attention": ("flash_wgmma_kernel",),
              "flash_attention_bwd": ("flash_bwd_dkdv_wgmma_kernel",
                                      "flash_bwd_dq_wgmma_kernel")}
    for lib, kernels in wanted.items():
        sass = subprocess.run(
            [str(tool), "-sass", str(_build.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        counts = {}
        for section in sass.split("Function : ")[1:]:
            name = section.splitlines()[0].strip()
            if any(k in name for k in kernels):
                counts[name] = {op: section.count(op)
                                for op in ("HGMMA", "UTMALDG", "SYNCS")}
        log(f"[build] HGMMA, UTMALDG and SYNCS instructions in the SASS of "
            f"{', '.join(kernels)}: {counts}")
        need = ("HGMMA",) if lib == "flash_attention" else (
            "HGMMA", "UTMALDG", "SYNCS")
        dims = HEAD_DIMS + (FWD_HEAD_DIMS if lib == "flash_attention"
                            else ())
        missing = [f"{k}<{hd}>" for k in kernels for hd in dims
                   if not any(f"{k}ILi{hd}E" in name for name in counts)]
        if missing:
            raise SystemExit(f"chip_smoke: {lib} has no instantiation of "
                             f"{missing} in its SASS")
        if not all(c[op] for c in counts.values() for op in need):
            raise SystemExit(f"chip_smoke: a bf16 kernel of {lib} lacks "
                             f"{' or '.join(need)} in its SASS")


# ---------------------------------------------------------------------- #
# 3 and 5. kernels against their plain versions, and their times
# ---------------------------------------------------------------------- #
def _inputs(torch, N, V, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn((N, V), generator=g, device="cuda") * 3).to(dt)
    y = (torch.randn((N, V), generator=g, device="cuda") * 3).to(dt)
    lab = torch.randint(0, V, (N,), generator=g, device="cuda",
                        dtype=torch.int32)
    grads = torch.randn((4, N), generator=g, device="cuda")
    return x, y, lab, grads


def _stopgrad_grads(torch, ref, x, y, lab, grads):
    """dx, dy by autograd of the plain forward, with the Eqs. 33-34
    stop-gradients: (ce_x, kl_xy) see y detached, (ce_y, kl_yx) x."""
    x = x.detach().requires_grad_(True)
    y = y.detach().requires_grad_(True)
    tx = ref.kd_loss_ref(x, y.detach(), lab)
    ty = ref.kd_loss_ref(x.detach(), y, lab)
    terms = (tx["ce_x"], ty["ce_y"], tx["kl_xy"], ty["kl_yx"])
    loss = sum((g * t).sum() for g, t in zip(grads, terms))
    return torch.autograd.grad(loss, (x, y))


def _max_err(torch, got, exp):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, exp))


def _close(torch, got, exp, tol, what):
    for a, b in zip(got, exp):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{what}: {m}")


def _close_kd(torch, got, exp, what):
    """kd_loss_fwd / kd_loss_bwd outputs against their plain versions at the
    kd limits (KD_BF16_RTOL above), each tensor by its own dtype."""
    for a, b in zip(got, exp):
        if a.dtype == torch.float32:
            atol = rtol = TOL["float32"]
        else:
            atol = KD_BF16_ATOL_SHARE * float(b.float().abs().max())
            rtol = KD_BF16_RTOL
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what}: {m}")


def phase_kernels(torch, shapes):
    """{(N, V, dtype): (fwd max|err|, bwd max|err|)} at each shape."""
    from repro_torch.kernels import kd_loss as kd, ref
    errs = {}
    with full_fp32(torch):
        for N, V, dtype in shapes:
            x, y, lab, grads = _inputs(torch, N, V, dtype, seed=N + V)
            terms, stats = kd.kd_loss_fwd(x, y, lab)
            dx, dy = kd.kd_loss_bwd(x, y, lab, stats, grads)
            torch.cuda.synchronize()
            exp_terms, exp_stats = ref.kd_loss_fwd_ref(x, y, lab)
            exp_dx, exp_dy = _stopgrad_grads(torch, ref, x, y, lab, grads)
            _close_kd(torch, (terms, stats), (exp_terms, exp_stats),
                      f"kd_loss_fwd {N}x{V} {dtype}")
            _close_kd(torch, (dx, dy), (exp_dx, exp_dy),
                      f"kd_loss_bwd {N}x{V} {dtype}")
            # the autograd.Function drives the same pair of kernels
            xa = x.detach().requires_grad_(True)
            ya = y.detach().requires_grad_(True)
            out = kd.kd_loss(xa, ya, lab)
            fdx, fdy = torch.autograd.grad(
                sum((g * out[k]).sum() for g, k in zip(grads, TERMS)),
                (xa, ya))
            _close_kd(torch, (fdx, fdy), (exp_dx, exp_dy),
                      f"KDLoss.backward {N}x{V} {dtype}")
            e_f = _max_err(torch, (terms, stats), (exp_terms, exp_stats))
            e_b = _max_err(torch, (dx, dy), (exp_dx, exp_dy))
            errs[(N, V, dtype)] = (e_f, e_b)
            log(f"[kernels] {N}x{V} {dtype}: fwd max|err| {e_f:.3e}, bwd "
                f"max|err| {e_b:.3e} (tol {KD_TOL_TEXT})")
    return errs


def phase_kd_bitwise(torch, cases):
    """kd_loss_fwd / kd_loss_bwd bitwise against themselves at each (N, V,
    dtype, (a, b)): two launches on the same inputs, and rows [a, b) of the
    N-row call against a call on the row slice x[a:b] (a view, so its rows
    keep their addresses and alignment); the slice's results are also held
    against the plain versions, which covers a slice whose base is not on
    16 bytes. Returns the seconds taken."""
    from repro_torch.kernels import kd_loss as kd, ref
    t0 = time.perf_counter()
    with full_fp32(torch):
        for N, V, dtype, (a, b) in cases:
            what = f"kd_loss {N}x{V} {dtype} rows {a}:{b}"
            x, y, lab, grads = _inputs(torch, N, V, dtype, seed=N + V + 1)
            whole = [kd.kd_loss_fwd(x, y, lab)]
            whole.append(kd.kd_loss_bwd(x, y, lab, whole[0][1], grads))
            again = [kd.kd_loss_fwd(x, y, lab)]
            again.append(kd.kd_loss_bwd(x, y, lab, again[0][1], grads))
            xs, ys, ls = x[a:b], y[a:b], lab[a:b]
            gs = grads[:, a:b].contiguous()
            part = [kd.kd_loss_fwd(xs, ys, ls)]
            part.append(kd.kd_loss_bwd(xs, ys, ls, part[0][1], gs))
            torch.cuda.synchronize()
            flat = lambda r: [t for pair in r for t in pair]
            if not all(torch.equal(p, q)
                       for p, q in zip(flat(whole), flat(again))):
                raise SystemExit(f"chip_smoke: {what}: two launches on the "
                                 f"same inputs differ")
            rows = [t[:, a:b] for t in whole[0]] + [t[a:b] for t in whole[1]]
            if not all(torch.equal(p, q) for p, q in zip(rows, flat(part))):
                raise SystemExit(f"chip_smoke: {what}: the slice's rows "
                                 f"differ from the same rows of the {N}-row "
                                 f"call")
            exp = list(ref.kd_loss_fwd_ref(xs, ys, ls))
            exp += _stopgrad_grads(torch, ref, xs, ys, ls, gs)
            _close_kd(torch, flat(part), exp, f"{what} (plain)")
            log(f"[kernels] {what}: two launches bitwise equal, the slice "
                f"(base {xs.data_ptr() % 16} bytes off 16) bitwise the "
                f"{N}-row call's rows, max|err| to plain "
                f"{_max_err(torch, flat(part), exp):.3e} (tol {KD_TOL_TEXT})")
            del x, y, whole, again, part, exp
    return time.perf_counter() - t0


def _grad_inputs(torch, C, B, V, dtype, seed):
    x, y, lab, _ = _inputs(torch, C * B, V, dtype, seed)
    return x.view(C, B, V), y.view(C, B, V), lab.view(C, B)


def close_kd_grad(torch, got, exp, what):
    """kd_loss_grad's (dx, dy, means) against its plain version: fp32
    gradients within rtol 1e-4 plus KD_GRAD_ATOL_SHARE of the tensor's
    largest |value|, bf16 ones at the KD_BF16_* limits, the four loss means
    at 1e-4 and the two accuracies exact. Raises AssertionError."""
    for a, b, name in zip(got[:2], exp[:2], ("dx", "dy")):
        scale = float(b.float().abs().max())
        if a.dtype == torch.float32:
            atol, rtol = KD_GRAD_ATOL_SHARE * scale, TOL["float32"]
        else:
            atol, rtol = KD_BF16_ATOL_SHARE * scale, KD_BF16_RTOL
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=lambda m: f"{what} {name}: {m}")
    torch.testing.assert_close(got[2][:4], exp[2][:4], atol=TOL["float32"],
                               rtol=TOL["float32"],
                               msg=lambda m: f"{what} means: {m}")
    if not torch.equal(got[2][4:], exp[2][4:]):
        raise AssertionError(f"{what}: accuracies {got[2][4:].tolist()} != "
                             f"{exp[2][4:].tolist()}")


def phase_kd_grad(torch, shapes):
    """{(C, B, V, dtype): max|err|} of kd_loss_grad against its plain
    version at close_kd_grad's limits; two launches bitwise equal (its sums
    take a fixed order; no float atomics); and, where C > 1, the last
    client's dx, dy and means bitwise those of a one-client call on its
    rows (the variant comes from V and the dtype, never from C or B)."""
    from repro_torch.kernels import kd_loss as kd, ref
    src = (Path(kd.__file__).parent / "csrc" / "kd_loss.cu").read_text()
    if f"constexpr int kPairSlice = {KD_PAIR_SLICE};" not in src:
        raise SystemExit("chip_smoke: kd_loss.cu's kPairSlice is not "
                         f"KD_PAIR_SLICE ({KD_PAIR_SLICE}): GRAD_SWITCH_SHAPES "
                         "no longer straddle kd_loss_grad's cluster switches")
    errs = {}
    with full_fp32(torch):
        for C, B, V, dtype in shapes:
            x, y, lab = _grad_inputs(torch, C, B, V, dtype, seed=C * B + V)
            got = kd.kd_loss_grad(x, y, lab, LAMBDAS)
            again = kd.kd_loss_grad(x, y, lab, LAMBDAS)
            one = (kd.kd_loss_grad(x[-1], y[-1], lab[-1], LAMBDAS)
                   if C > 1 else None)
            torch.cuda.synchronize()
            exp = ref.kd_loss_grad_ref(x, y, lab, LAMBDAS)
            what = f"kd_loss_grad {C}x{B}x{V} {dtype}"
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"chip_smoke: {what}: two launches on the "
                                 f"same inputs differ")
            if one is not None and not (
                    torch.equal(one[0], got[0][-1])
                    and torch.equal(one[1], got[1][-1])
                    and torch.equal(one[2][:, 0], got[2][:, -1])):
                raise SystemExit(f"chip_smoke: {what}: client {C - 1} differs "
                                 f"from a one-client call on its rows")
            close_kd_grad(torch, got, exp, what)
            pairs = ((got[0], got[1], got[2][:4]), (exp[0], exp[1], exp[2][:4]))
            errs[(C, B, V, dtype)] = e = _max_err(torch, *pairs)
            log(f"[kernels] {what}: max|err| {e:.3e} ({KD_GRAD_TOL_TEXT}), "
                f"accuracies exact, two launches bitwise equal"
                + (f", client {C - 1} bitwise a one-client call"
                   if C > 1 else ""))
            del x, y, got, again, one, exp
    return errs


def _graph_ms(torch, fn, iters):
    """Device ms per call: `iters` calls captured into one CUDA graph, whose
    replay is timed with CUDA events. The host issues one replay, so its
    per-call cost (Python, the wrapper's checks, ctypes) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _eager_ms(torch, fn, iters):
    """Wall ms per call of back-to-back eager calls, ended by a sync: the
    host's issue cost when it exceeds the device's time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def kd_inputs_cold(torch, N, V, dtype):
    """Functions giving the next (x, y, labels) and (x, y, labels, stats,
    grads) of kd_loss_fwd / kd_loss_bwd at (N, V, dtype), cycling over
    enough copies to spill the L2 between two uses of one copy."""
    from repro_torch.kernels import kd_loss as kd
    x, y, lab, grads = _inputs(torch, N, V, dtype, seed=7)
    _, stats = kd.kd_loss_fwd(x, y, lab)
    nbytes = 2 * N * V * x.element_size()
    return (_cold_copies((x, y, lab), nbytes),
            _cold_copies((x, y, lab, stats, grads), 2 * nbytes))


def phase_timing(torch, shapes):
    """{(kernel, N, V, dtype): times} at each shape, for the kernel and its
    plain version: device ms from graph replays over inputs that spill the
    L2 (as the bound assumes), eager wall ms per call on one fixed set of
    inputs (the host's cost of a call)."""
    from repro_torch.kernels import kd_loss as kd, ref
    times = {}
    for N, V, dtype in shapes:
        fwd_in, bwd_in = kd_inputs_cold(torch, N, V, dtype)
        fwd_one, bwd_one = fwd_in(), bwd_in()
        iters = 200 if N * V < 1e6 else 20
        fns = {"kd_loss_fwd": (lambda: kd.kd_loss_fwd(*fwd_in()),
                               lambda: ref.kd_loss_fwd_ref(*fwd_in()),
                               lambda: kd.kd_loss_fwd(*fwd_one),
                               lambda: ref.kd_loss_fwd_ref(*fwd_one)),
               "kd_loss_bwd": (lambda: kd.kd_loss_bwd(*bwd_in()),
                               lambda: ref.kd_loss_bwd_ref(*bwd_in()),
                               lambda: kd.kd_loss_bwd(*bwd_one),
                               lambda: ref.kd_loss_bwd_ref(*bwd_one))}
        bounds = _cost().kd_bounds(N, V, 2 if dtype == "bfloat16" else 4)
        for name, (kernel, plain, kernel_one, plain_one) in fns.items():
            # plain, kernel, kernel, plain: the two kernel and two plain
            # timings are averaged, so drift in clocks hits both alike
            p1 = _graph_ms(torch, plain, iters)
            k1 = _graph_ms(torch, kernel, iters)
            k2 = _graph_ms(torch, kernel, iters)
            p2 = _graph_ms(torch, plain, iters)
            k_eager = _eager_ms(torch, kernel_one, iters)
            p_eager = _eager_ms(torch, plain_one, iters)
            b_ms, b_by = bounds[name]
            t = times[(name, N, V, dtype)] = {
                "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                "bound_ms": b_ms, "bound_by": b_by,
                "share": b_ms * 2 / (k1 + k2),
                "eager_ms": k_eager, "plain_eager_ms": p_eager}
            log(f"[timing] {name} {N}x{V} {dtype}: kernel device "
                f"{t['ms']:.6f} ms ({k1:.6f}, {k2:.6f}), plain device "
                f"{t['plain_ms']:.6f} ms, bound {b_ms:.7f} ms by {b_by} "
                f"(3.35 TB/s, 67 TFLOP/s fp32), {100 * t['share']:.1f}% of "
                f"it; eager wall per call: kernel {k_eager:.6f} ms, plain "
                f"{p_eager:.6f} ms")
    return times


def phase_grad_timing(torch, shapes, iters=None):
    """Times of kd_loss_grad and its plain version at each (C, B, V,
    dtype), over `iters` calls (by default 200, or 20 at a million logits
    and more); no single PyTorch call computes the same function."""
    from repro_torch.kernels import kd_loss as kd, ref
    times = {}
    for C, B, V, dtype in shapes:
        x, y, lab = _grad_inputs(torch, C, B, V, dtype, seed=7)
        fns = {"kernel": lambda: kd.kd_loss_grad(x, y, lab, LAMBDAS),
               "plain": lambda: ref.kd_loss_grad_ref(x, y, lab, LAMBDAS),
               "library": None, "kernel_warm": None}
        times[("kd_loss_grad", C, B, V, dtype)] = _time_set(
            torch, "kd_loss_grad", (C, B, V, dtype), fns,
            _cost().grad_bound(C, B, V, x.element_size()),
            iters or (200 if C * B * V < 1e6 else 20))
    return times


# ---------------------------------------------------------------------- #
# 3 and 6. rmsnorm and flash attention against their plain versions, and
# their times
# ---------------------------------------------------------------------- #
def _randn(torch, shape, dtype, g, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        getattr(torch, dtype))


def _norm_inputs(torch, N, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(N + d)
    return (_randn(torch, (N, d), dtype, g),
            (1 + _randn(torch, (d,), "float32", g, 0.1)).to(
                getattr(torch, dtype)))


def _add_norm_inputs(torch, N, d, dtype):
    x, sc = _norm_inputs(torch, N, d, dtype)
    g = torch.Generator(device="cuda").manual_seed(N * d)
    return x, _randn(torch, (N, d), dtype, g), sc


def _flash_inputs(torch, B, H, KV, S, hd, dtype, layout):
    """q (B, H, S, hd), k and v (B, KV, S, hd): contiguous for layout
    "bhsd", the transposed views of (B, S, H, hd) tensors for "bshd"."""
    g = torch.Generator(device="cuda").manual_seed(B * S + hd)
    if layout == "bhsd":
        return (_randn(torch, (B, H, S, hd), dtype, g),
                _randn(torch, (B, KV, S, hd), dtype, g),
                _randn(torch, (B, KV, S, hd), dtype, g))
    return tuple(_randn(torch, (B, S, n, hd), dtype, g).transpose(1, 2)
                 for n in (H, KV, KV))


def phase_norm_flash_kernels(torch):
    """{("rmsnorm", N, d, dtype) | ("flash_attention", B, H, KV, S, hd,
    window, dtype, layout): max|err|} against the plain versions."""
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn
    errs = {}
    with full_fp32(torch):
        for N, d, dtype in NORM_SHAPES:
            x, sc = _norm_inputs(torch, N, d, dtype)
            got = rn.rmsnorm(x, sc)
            torch.cuda.synchronize()
            exp = ref.rmsnorm_ref(x, sc)
            tol = TOL_NORM[dtype]
            _close(torch, (got,), (exp,), tol, f"rmsnorm {N}x{d} {dtype}")
            errs[("rmsnorm", N, d, dtype)] = e = _max_err(torch, (got,), (exp,))
            log(f"[kernels] rmsnorm {N}x{d} {dtype}: max|err| {e:.3e} "
                f"(tol {tol})")
        for N, d, dtype in NORM_SHAPES:
            x, delta, sc = _add_norm_inputs(torch, N, d, dtype)
            s, y = rn.add_rmsnorm(x, delta, sc)
            s2 = x + delta
            y2 = rn.rmsnorm(s2, sc)
            torch.cuda.synchronize()
            what = f"add_rmsnorm {N}x{d} {dtype}"
            if not (torch.equal(s, s2) and torch.equal(y, y2)):
                raise SystemExit(f"chip_smoke: {what} is not bitwise equal "
                                 f"to x + delta and the rmsnorm kernel")
            exp = ref.add_rmsnorm_ref(x, delta, sc)
            tol = TOL_NORM[dtype]
            _close(torch, (s, y), exp, tol, what)
            errs[("add_rmsnorm", N, d, dtype)] = e = _max_err(
                torch, (s, y), exp)
            log(f"[kernels] {what}: bitwise equal to x + delta and rmsnorm; "
                f"max|err| against the plain version {e:.3e} (tol {tol})")
        for B, H, KV, S, hd, window, dtype, layout in FLASH_SHAPES:
            q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
            got = fa.flash_attention(q, k, v, causal=True,
                                     sliding_window=window)
            torch.cuda.synchronize()
            exp = ref.flash_attention_ref(q, k, v, causal=True,
                                          sliding_window=window)
            tol = TOL_FLASH[dtype]
            what = (f"flash_attention B{B} H{H} KV{KV} S{S} hd{hd} "
                    f"window {window} {dtype} {layout}")
            _close(torch, (got,), (exp,), tol, what)
            key = ("flash_attention", B, H, KV, S, hd, window, dtype, layout)
            errs[key] = e = _max_err(torch, (got,), (exp,))
            log(f"[kernels] {what}: max|err| {e:.3e} (tol {tol})")
    return errs


def phase_bwd_kernels(torch):
    """{("rmsnorm_bwd" | "add_rmsnorm_bwd", N, d, dtype) |
    ("flash_attention_bwd", B, H, KV, S, hd, window, dtype, layout):
    max|err|} of the backward kernels against their plain closed forms at
    the norm and flash tolerances. dscale is a sum over N rows taken in
    another order than the plain version's, so its absolute tolerance is
    the norm tolerance times sqrt(N), the sum's spread. Two launches on the
    same inputs must be bitwise equal; the flash forward's o must be the
    same bits with and without its lse output, and lse must match the plain
    log-sum-exp at the fp32 flash tolerance."""
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn
    errs = {}
    with full_fp32(torch):
        for N, d, dtype in NORM_BWD_SHAPES:
            x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
            g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
            gs = _randn(torch, (N, d), dtype, g)
            tol = TOL_NORM[dtype]
            for name, run, plain in (
                    ("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(x, sc, dy),
                     lambda: ref.rmsnorm_bwd_ref(x, sc, dy)),
                    ("add_rmsnorm_bwd",
                     lambda: rn.add_rmsnorm_bwd(x, sc, gs, dy),
                     lambda: ref.add_rmsnorm_bwd_ref(x, sc, gs, dy)),
                    ("add_rmsnorm_bwd (no g_s)",
                     lambda: rn.add_rmsnorm_bwd(x, sc, None, dy),
                     lambda: ref.add_rmsnorm_bwd_ref(x, sc, None, dy))):
                got, again = run(), run()
                torch.cuda.synchronize()
                what = f"{name} {N}x{d} {dtype}"
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise SystemExit(f"chip_smoke: {what}: two launches on "
                                     f"the same inputs differ")
                exp = plain()
                _close(torch, got[:1], exp[:1], tol, what)
                torch.testing.assert_close(
                    got[1].float(), exp[1].float(), atol=tol * N ** 0.5,
                    rtol=tol, msg=lambda m: f"{what} dscale: {m}")
                key = (name.split(" ")[0], N, d, dtype)
                e = _max_err(torch, got, exp)
                errs[key] = max(errs.get(key, 0.0), e)
                log(f"[kernels] {what}: max|err| {e:.3e} (tol {tol}; "
                    f"dscale atol {tol * N ** 0.5:.2e}), two launches "
                    f"bitwise equal")
        check_norm_bwd_graph(torch)
        for B, H, KV, S, hd, window, dtype, layout in FLASH_BWD_SHAPES:
            q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
            what = (f"flash_attention_bwd B{B} H{H} KV{KV} S{S} hd{hd} "
                    f"window {window} {dtype} {layout}")
            o, lse = fa._launch(q, k, v, True, window, with_lse=True)
            o_plain = fa._launch(q, k, v, True, window)
            if not torch.equal(o, o_plain):
                raise SystemExit(f"chip_smoke: {what}: the forward's o "
                                 f"differs with its lse output")
            _, exp_lse = ref.flash_attention_ref(
                q, k, v, sliding_window=window, return_lse=True)
            _close(torch, (lse,), (exp_lse,), TOL_FLASH["float32"],
                   f"{what} lse")
            g = torch.Generator(device="cuda").manual_seed(S * hd + 1)
            do = _randn(torch, (B, S, H, hd), dtype, g).transpose(1, 2)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                         sliding_window=window)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           sliding_window=window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SystemExit(f"chip_smoke: {what}: two launches on the "
                                 f"same inputs differ")
            exp = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                              sliding_window=window)
            tol = TOL_FLASH[dtype]
            _close(torch, got, exp, tol, what)
            key = ("flash_attention_bwd", B, H, KV, S, hd, window, dtype,
                   layout)
            errs[key] = e = _max_err(torch, got, exp)
            log(f"[kernels] {what}: max|err| of dq, dk, dv {e:.3e} (tol "
                f"{tol}); o bitwise unchanged by lse; two launches bitwise "
                f"equal")
    return errs


def check_norm_bwd_graph(torch):
    """The norm backward, replayed from a CUDA graph, gives the bits of an
    eager launch on the same inputs: its dscale reduction's counters reset
    themselves within the launch."""
    from repro_torch.kernels import rmsnorm as rn
    N, d, dtype = NORM_BWD_SHAPES[0]
    x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
    g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
    gs = _randn(torch, (N, d), dtype, g)
    for name, run in (("rmsnorm_bwd", lambda: rn.rmsnorm_bwd(x, sc, dy)),
                      ("add_rmsnorm_bwd",
                       lambda: rn.add_rmsnorm_bwd(x, sc, gs, dy))):
        eager = run()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, eager)):
                raise SystemExit(f"chip_smoke: {name} {(N, d, dtype)} "
                                 f"replayed from a CUDA graph differs from "
                                 f"an eager launch")
        log(f"[kernels] {name} {(N, d, dtype)}: 3 CUDA-graph replays "
            f"bitwise equal to an eager launch")


def _time_set(torch, name, shape, fns, bound, iters):
    """fns: {"kernel", "plain", "library" (or None), "kernel_warm"} ->
    times dict. kernel, plain and library cycle over enough copies of
    their inputs to spill the L2 cache between two uses of one copy, so
    that each call reads its inputs from device memory, as the bound
    assumes; kernel_warm reuses one copy, which stays in L2 when it fits."""
    # plain, kernel, kernel, plain: the two kernel and two plain timings are
    # averaged, so drift in clocks hits both alike; the library call last
    p1 = _graph_ms(torch, fns["plain"], iters)
    k1 = _graph_ms(torch, fns["kernel"], iters)
    k2 = _graph_ms(torch, fns["kernel"], iters)
    p2 = _graph_ms(torch, fns["plain"], iters)
    lib = (_graph_ms(torch, fns["library"], iters)
           if fns["library"] is not None else None)
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "bound_ms": bound[0], "bound_by": bound[1],
           "eager_ms": _eager_ms(torch, fns["kernel"], iters),
           "plain_eager_ms": _eager_ms(torch, fns["plain"], iters),
           "library_ms": lib,
           "warm_ms": (_graph_ms(torch, fns["kernel_warm"], iters)
                       if fns["kernel_warm"] is not None else None)}
    warm = ("" if out["warm_ms"] is None else
            f"; {out['warm_ms']:.6f} with its inputs in L2")
    log(f"[timing] {name} {shape}: kernel device {out['ms']:.6f} ms ({k1:.6f}, "
        f"{k2:.6f}{warm}), plain "
        f"device {out['plain_ms']:.6f} ms, library "
        f"{'none' if lib is None else f'{lib:.6f} ms'}, bound "
        f"{bound[0]:.7f} ms by {bound[1]}; eager wall per call: kernel "
        f"{out['eager_ms']:.6f} ms, plain {out['plain_eager_ms']:.6f} ms")
    return out


def _cold_copies(tensors, nbytes):
    """Clones of `tensors` (a call's inputs; the call moves `nbytes` in
    all), enough that cycling through them moves twice the L2 between two
    uses of one set, at most 64; returns a function giving the next set."""
    n = max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))
    sets = [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]
    order = itertools.cycle(range(n))
    return lambda: sets[next(order)]


def _sdpa(torch):
    """F.scaled_dot_product_attention with grouped KV heads: the library
    yardstick for flash_attention (timed only, never called by the port)."""
    import torch.nn.functional as F

    def call(q, k, v, window):
        if window:
            S = q.shape[2]
            i = torch.arange(S, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    return call


def phase_norm_flash_timing(torch, norm_shapes, add_shapes, flash_shapes):
    """Times of rmsnorm and add_rmsnorm at each (N, d, dtype) and of
    flash_attention at each (B, H, KV, S, hd, window, dtype, layout)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn

    def rms_norm(x, scale):
        return F.rms_norm(x, (x.shape[-1],), scale, 1e-5)

    def add_rms_norm(x, delta, scale):
        s = x + delta
        return s, rms_norm(s, scale)

    times = {}
    for N, d, dtype in norm_shapes:
        x, sc = _norm_inputs(torch, N, d, dtype)
        nxt = _cold_copies((x, sc), 2 * x.numel() * x.element_size())
        fns = {"kernel": lambda: rn.rmsnorm(*nxt()),
               "plain": lambda: ref.rmsnorm_ref(*nxt()),
               "library": lambda: rms_norm(*nxt()),
               "kernel_warm": lambda: rn.rmsnorm(x, sc)}
        times[("rmsnorm", N, d, dtype)] = _time_set(
            torch, "rmsnorm", (N, d, dtype), fns,
            _cost().norm_bound(N, d, x.element_size()),
            200 if N * d < 1e6 else 50)
    for N, d, dtype in add_shapes:
        x, delta, sc = _add_norm_inputs(torch, N, d, dtype)
        nxt = _cold_copies((x, delta, sc), 4 * x.numel() * x.element_size())
        fns = {"kernel": lambda: rn.add_rmsnorm(*nxt()),
               "plain": lambda: ref.add_rmsnorm_ref(*nxt()),
               "library": lambda: add_rms_norm(*nxt()),
               "kernel_warm": lambda: rn.add_rmsnorm(x, delta, sc)}
        times[("add_rmsnorm", N, d, dtype)] = _time_set(
            torch, "add_rmsnorm", (N, d, dtype), fns,
            _cost().add_norm_bound(N, d, x.element_size()),
            200 if N * d < 1e6 else 50)
    sdpa = _sdpa(torch)
    for B, H, KV, S, hd, window, dtype, layout in flash_shapes:
        q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
        nxt = _cold_copies((q, k, v), (2 * q.numel() + k.numel()
                                       + v.numel()) * q.element_size())
        fns = {"kernel": lambda: fa.flash_attention(
                   *nxt(), causal=True, sliding_window=window),
               "plain": lambda: ref.flash_attention_ref(
                   *nxt(), causal=True, sliding_window=window),
               "library": lambda: sdpa(*nxt(), window),
               "kernel_warm": lambda: fa.flash_attention(
                   q, k, v, causal=True, sliding_window=window)}
        key = ("flash_attention", B, H, KV, S, hd, window, dtype, layout)
        times[key] = _time_set(
            torch, "flash_attention", key[1:], fns,
            _cost().flash_bound(B, H, KV, S, hd, window, dtype,
                                q.element_size()), 10)
    return times


# ---------------------------------------------------------------------- #
# 3b. the optimizer's fused kernels at the train cells' leaf sets
# ---------------------------------------------------------------------- #
#: the benchmark's train cells whose leaf sets phase 3b runs
ADAMW_CELLS = ("qwen3moe-l4-train-b4s2048", "qwen2vl-train-b4s2048")


def hf_model_config(cj, name, lite=False):
    """The port's ModelConfig of a configuration file with Hugging Face's
    key names (portbench/configs/), or of its LiteModel (`cj["lite"]`,
    whose keys override the model's): the sizes that shape its leaves."""
    import torch
    from repro_torch.configs.base import ModelConfig
    src = {**cj, **(cj["lite"] if lite else {})}
    experts = src.get("num_experts", 0)
    embeddings = src.get("input_mode", "tokens") == "embeddings"
    return ModelConfig(
        name=name, family="moe" if experts else "vlm" if embeddings
        else "dense", n_layers=src["num_hidden_layers"],
        d_model=src["hidden_size"], n_heads=src["num_attention_heads"],
        n_kv_heads=src["num_key_value_heads"],
        d_ff=0 if experts else src["intermediate_size"],
        vocab_size=src["vocab_size"], head_dim=src.get("head_dim", 0),
        n_experts=experts,
        top_k=src.get("num_experts_per_tok", 0) if experts else 0,
        moe_d_ff=src.get("moe_intermediate_size", 0) if experts else 0,
        mrope_sections=tuple((src.get("rope_scaling") or {}).get(
            "mrope_section", ())),
        input_mode="embeddings" if embeddings else "tokens",
        tie_embeddings=src["tie_word_embeddings"],
        dtype=getattr(torch, src["torch_dtype"]))


def adamw_cell(cell):
    """(leaf shapes and dtypes of both models, the cell's step settings) of
    a portbench train cell, its models built on the meta device from its
    configuration file."""
    import torch
    from repro_torch.models.api import init_model
    from repro_torch.utils.pytree import tree_leaves
    wl = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json")
                    .read_text())
    cj = json.loads((ROOT / "portbench" / "configs" / f"{wl['config']}.json")
                    .read_text())
    leaves = []
    for lite in (False, True):
        cfg = hf_model_config(cj, cell, lite)
        with torch.device("meta"):
            tree = init_model(torch.Generator().manual_seed(0), cfg, "meta")
        leaves += [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]
    return leaves, wl["step"]


def _adamw_leaf(torch, shape, dtype, seed):
    """One leaf's seeded (g, p, m, v) before a step: g N(0, 1e-3) and p
    N(0, 0.02) in the param's dtype, m N(0, 1e-4), v its square plus
    N(0, 1e-4)^2, fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(std):
        return torch.randn(shape, generator=gen, device="cuda") * std
    g, p = draw(1e-3).to(dtype), draw(0.02).to(dtype)
    m = draw(1e-4)
    v = m.square() + draw(1e-4).square()
    return g, p, m, v


def phase_adamw(torch):
    """Phase 3b: the norm and update kernels over each train cell's whole
    leaf set, seeded, one step from step 4: the update's p, m and v
    bitwise `adamw_plain_`'s given the plain norm's clip factor (each leaf
    re-drawn from its seed for the plain version), the kernels' norm
    against the plain sum and a float64 one, launches a step, and device
    ms (CUDA-graph replays) beside the byte bound and the plain versions'
    ms (CUDA events around one eager call; their few hundred launches issue
    far faster than the card runs them)."""
    from repro_torch.kernels import adamw as fa
    from repro_torch.optim import optimizers as topt
    out = {}
    for cell in ADAMW_CELLS:
        t0 = time.perf_counter()
        leaves, hp = adamw_cell(cell)
        seeds = [1000 * (ADAMW_CELLS.index(cell) + 1) + i
                 for i in range(len(leaves))]
        g, p, m, v = (list(t) for t in zip(*[
            _adamw_leaf(torch, s, dt, seed)
            for (s, dt), seed in zip(leaves, seeds)]))
        n = sum(t.numel() for t in p)
        work = [(t.numel(), t.element_size(), q.element_size())
                for t, q in zip(g, p)]
        hyper = {"lr": hp["lr"], "weight_decay": hp.get("weight_decay", 0.0)}
        opt = topt.adamw(**hyper)
        step0 = torch.tensor(4, dtype=torch.int32, device="cuda")
        state = {"step": step0.clone(), "m": m, "v": v}
        gn_plain = topt.global_norm_plain(g)
        scale = topt.clip_scale(gn_plain, hp["grad_clip"])
        gn64 = math.sqrt(sum(float(t.double().square().sum()) for t in g))
        fa.reset_launches()
        gn = topt.global_norm(g)
        opt.update_(g, state, p, scale)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        gn_again = topt.global_norm(g)
        # the plain version leaf by leaf from the same seeded state
        bitwise = True
        for i, ((shape, dt), seed) in enumerate(zip(leaves, seeds)):
            lg, lp, lm, lv = _adamw_leaf(torch, shape, dt, seed)
            topt.adamw_plain_([lg], {"step": step0.clone(), "m": [lm],
                                     "v": [lv]}, [lp], scale, **hyper)
            same = all(torch.equal(a, b) for a, b in
                       ((p[i], lp), (m[i], lm), (v[i], lv)))
            if not same:
                log(f"[adamw] {cell}: leaf {i} {shape} {dt} differs from "
                    f"the plain version")
            bitwise &= same
            del lg, lp, lm, lv
        # device ms; the replays step the state on, which times alike
        lr_t, bc1, bc2 = (torch.tensor(x, device="cuda") for x in (
            hp["lr"], 0.1, 1e-3))
        wd = hp.get("weight_decay", 0.0)
        upd_ms = _graph_ms(torch, lambda: fa.adamw_(
            g, p, m, v, lr_t, bc1, bc2, scale, 0.9, 0.999, 1e-8, wd), 5)
        norm_ms = _graph_ms(torch, lambda: fa.global_norm(g), 20)
        plain = {}
        for name, fn in (
                ("update", lambda: topt.adamw_plain_(g, state, p, scale,
                                                     **hyper)),
                ("norm", lambda: topt.global_norm_plain(g))):
            fn()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            plain[name] = start.elapsed_time(end)
        upd_bound, _ = _cost().adamw_bound(work)
        norm_bound, _ = _cost().sumsq_bound(work)
        rec = out[cell] = {
            "leaves": len(leaves), "params": n, "bitwise": bitwise,
            "gn_rel_fp64": abs(float(gn) - gn64) / gn64,
            "gn_rel_plain": abs(float(gn) - float(gn_plain)) / gn64,
            "gn_repeats": bool(torch.equal(gn, gn_again)),
            "launches": launches,
            "update": {"ms": upd_ms, "bound_ms": upd_bound,
                       "share": upd_bound / upd_ms,
                       "bytes": _cost().adamw_work(work)[0],
                       "plain_ms": plain["update"]},
            "norm": {"ms": norm_ms, "bound_ms": norm_bound,
                     "share": norm_bound / norm_ms,
                     "bytes": _cost().sumsq_work(work)[0],
                     "plain_ms": plain["norm"]},
            "wall_s": time.perf_counter() - t0}
        log(f"[adamw] {cell}: {json.dumps(rec)}")
        if not (bitwise and rec["gn_repeats"] and rec["gn_rel_fp64"] < 1e-5
                and launches == {"sumsq": 1, "sumsq_finish": 1, "adamw": 1}):
            raise SystemExit(f"chip_smoke: the optimizer kernels failed at "
                             f"{cell}: {rec}")
        del g, p, m, v, state, gn, gn_again, scale, gn_plain
        free_device_memory(torch)
    return out


# ---------------------------------------------------------------------- #
# 4. the HAPFL path
# ---------------------------------------------------------------------- #
# ---------------------------------------------------------------------- #
# 3c. the decode attention (kernels/decode_attention.py) at every decode
# shape of the serve paths and of both serve cells
# ---------------------------------------------------------------------- #
#: the serve cells' decode attention (B, H, KV, L, hd, dtype), timed at
#: DECODE_TIMED_VALID filled slots: qwen3moe-serve-b32's and zamba2-serve's
DECODE_CELLS = [(32, 32, 4, 1024, 128, "bfloat16"),
                (32, 32, 32, 1024, 224, "bfloat16")]
DECODE_TIMED_VALID = 545
#: the shapes whose graph replays are held against eager launches
DECODE_GRAPHED = DECODE_CELLS + [(2, 24, 8, 256, 128, "float32")]
#: the kernel's max|err| against float64: at most TOL_DECODE, and at most
#: the plain version's (which rounds scores and probabilities to the dtype)
#: or DECODE_FLOOR where that is smaller (fp32: sums in another order; bf16:
#: one rounding of an output below 2)
TOL_DECODE = {"float32": 1e-5, "bfloat16": 1e-2}
DECODE_FLOOR = {"float32": 2e-6, "bfloat16": 2.0 ** -8}


def decode_shape(cfg, B, max_len):
    """(B, H, KV, L, hd, dtype) of `cfg`'s decode attention at batch B and
    max_len (L: the ring, at most the sliding window)."""
    L = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return (B, cfg.n_heads, cfg.n_kv_heads, L, cfg.resolved_head_dim,
            str(cfg.dtype).removeprefix("torch."))


def decode_scale(hd):
    """The scale of a decode shape's scores: Zamba2-7B's (hd / 2)^-0.5 at its
    hd 224, else None (1/sqrt(hd))."""
    return (hd / 2) ** -0.5 if hd == 224 else None


def decode_shapes():
    """The decode attention's (B, H, KV, L, hd, dtype) of every config with
    attention: at SERVE's batch and max_len in bf16 (phase 5's serve
    paths), at B 2, L 256 in fp32 (the parity cuts' dtype), its smoke cut's
    heads (G 1, 2, 4 at hd 64) too, and the cells'."""
    from repro_torch.configs import ARCH_IDS, get_config
    out = set(DECODE_CELLS)
    for arch in list(ARCH_IDS) + [ZAMBA2["arch"]]:
        cfg = get_config(arch)
        if cfg.block_kind == "xlstm":
            continue
        out.add(decode_shape(cfg, SERVE["batch"], SERVE["max_len"]))
        for c in (cfg, cfg.smoke()):
            out.add((2, c.n_heads, c.n_kv_heads, 256, c.resolved_head_dim,
                     "float32"))
    return sorted(out)


def decode_positions(L):
    """Positions a decode shape is checked at: kv_valid 1, 545 (or L / 2
    below it), L, and a ring wrapped 37 slots past L."""
    return sorted({0, (DECODE_TIMED_VALID if L > DECODE_TIMED_VALID
                       else L // 2) - 1, L - 1, L + 36})


def _decode_inputs(torch, B, H, KV, L, hd, dtype):
    g = torch.Generator(device="cuda").manual_seed(B * L + H * hd + KV)
    return (_randn(torch, (B, 1, H, hd), dtype, g),
            _randn(torch, (B, L, KV, hd), dtype, g),
            _randn(torch, (B, L, KV, hd), dtype, g))


def decode_exact(torch, q, k, v, index, scale):
    """The decode attention in float64 over the kv_valid filled slots."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    n = min(index + 1, k.shape[1])
    qd = q.double().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qd, k[:, :n].double()) * (
        hd ** -0.5 if scale is None else scale)
    o = torch.einsum("bkgt,btkh->bkgh", torch.softmax(s, -1),
                     v[:, :n].double())
    return o.reshape(B, 1, H, hd)


def check_decode_attention(torch, shape, index):
    """The kernel at one shape and position against float64 and the plain
    version (TOL_DECODE, DECODE_FLOOR), and two launches bitwise. Returns
    (kernel max|err|, plain max|err|)."""
    from repro_torch.kernels import decode_attention as da, ref
    B, H, KV, L, hd, dtype = shape
    scale = decode_scale(hd)
    q, k, v = _decode_inputs(torch, *shape)
    pos = torch.tensor(index, device="cuda")
    got = da.decode_attention(q, k, v, pos, scale=scale)
    again = da.decode_attention(q, k, v, pos, scale=scale)
    torch.cuda.synchronize()
    with full_fp32(torch):
        plain = ref.decode_attention_ref(q, k, v, pos, scale=scale)
    exact = decode_exact(torch, q, k, v, index, scale)
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    what = (f"decode_attention B{B} H{H} KV{KV} L{L} hd{hd} {dtype} at "
            f"kv_valid {min(index + 1, L)} (position {index})")
    if got.shape != q.shape or got.dtype != q.dtype or not torch.equal(
            got, again):
        raise SystemExit(f"chip_smoke: {what}: {tuple(got.shape)} "
                         f"{got.dtype}, two launches bitwise "
                         f"{torch.equal(got, again)}")
    if not (err <= TOL_DECODE[dtype]
            and err <= max(plain_err, DECODE_FLOOR[dtype])):
        raise SystemExit(f"chip_smoke: {what}: max|err| {err:.3e} against "
                         f"float64, the plain version's {plain_err:.3e} "
                         f"(tol {TOL_DECODE[dtype]}, floor "
                         f"{DECODE_FLOOR[dtype]})")
    return err, plain_err


def check_decode_graph(torch, shape):
    """One launch captured in a CUDA graph on a static position, replayed at
    each of `decode_positions`: bitwise the eager launch there."""
    from repro_torch.kernels import decode_attention as da
    B, H, KV, L, hd, dtype = shape
    q, k, v = _decode_inputs(torch, *shape)
    pos = torch.zeros((), dtype=torch.int64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, v, pos, scale=decode_scale(hd))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, pos, scale=decode_scale(hd))
    for index in decode_positions(L):
        pos.fill_(index)
        graph.replay()
        eager = da.decode_attention(q, k, v, pos, scale=decode_scale(hd))
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            raise SystemExit(f"chip_smoke: decode_attention {shape}: the "
                             f"graph replay at position {index} differs "
                             f"from the eager launch")


def time_decode_attention(torch, shape, n_valid=DECODE_TIMED_VALID):
    """The kernel's device ms at `shape` with n_valid filled slots against
    its byte bound, the plain version's and SDPA's over the filled slots
    (the yardstick; the port never calls it), each call on inputs cold in
    the L2."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost, decode_attention as da, ref
    B, H, KV, L, hd, dtype = shape
    scale = decode_scale(hd)
    q, k, v = _decode_inputs(torch, *shape)
    pos = torch.tensor(n_valid - 1, device="cuda")
    work = cost.decode_attention_work(B, H, KV, n_valid, hd,
                                      q.element_size())
    nxt = _cold_copies((q, k, v), work[0])

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_[:, :n_valid].transpose(1, 2),
            v_[:, :n_valid].transpose(1, 2), scale=scale, enable_gqa=True)
    fns = {"kernel": lambda: da.decode_attention(*nxt(), pos, scale=scale),
           "plain": lambda: ref.decode_attention_ref(*nxt(), pos,
                                                     scale=scale),
           "library": lambda: sdpa(*nxt()),
           "kernel_warm": lambda: da.decode_attention(q, k, v, pos,
                                                      scale=scale)}
    return _time_set(torch, "decode_attention", (*shape, n_valid), fns,
                     cost.decode_attention_bound(B, H, KV, n_valid, hd,
                                                 q.element_size()), 20)


def phase_decode_attention(torch):
    """Phase 3c: the decode attention at every shape of `decode_shapes` and
    position of `decode_positions` (`check_decode_attention`), graphed ==
    eager at the cells' shapes and one fp32 shape, and its times at the
    cells' shapes. Returns ({("decode_attention", *shape): max|err|},
    {("decode_attention", *shape): times})."""
    t0 = time.perf_counter()
    errs = {}
    for shape in decode_shapes():
        pairs = [check_decode_attention(torch, shape, index)
                 for index in decode_positions(shape[3])]
        errs[("decode_attention", *shape)] = max(e for e, _ in pairs)
        log(f"[decode] {shape}: max|err| against float64 "
            f"{max(e for e, _ in pairs):.3e}, the plain version's "
            f"{max(e for _, e in pairs):.3e}, over positions "
            f"{decode_positions(shape[3])}; two launches bitwise")
        free_device_memory(torch)
    for shape in DECODE_GRAPHED:
        check_decode_graph(torch, shape)
    log(f"[decode] graph replays == eager launches bitwise at "
        f"{DECODE_GRAPHED}")
    times = {}
    for shape in DECODE_CELLS:
        times[("decode_attention", *shape)] = t = time_decode_attention(
            torch, shape)
        log(f"[decode] {shape} at {DECODE_TIMED_VALID} filled slots: "
            f"{t['ms']:.6f} ms, {100 * t['bound_ms'] / t['ms']:.1f}% of the "
            f"{t['bound_ms']:.6f} ms byte bound; plain {t['plain_ms']:.6f}, "
            f"SDPA {t['library_ms']:.6f} ms")
        free_device_memory(torch)
    log(f"[decode] phase 3c {time.perf_counter() - t0:.2f} s")
    return errs, times


def main_path_config():
    from repro_torch.fl import FLSimConfig
    # paper Table II: K=10 clients, k=6 per round, E=20, batch 32; the
    # cifar10 pool's large CNN is channels (32, 64, 128), hidden 128
    return FLSimConfig(dataset="cifar10", n_clients=10, k_per_round=6,
                       size_names=("small", "large"), default_epochs=20,
                       batch_size=32, batches_per_epoch=2)


def padded_steps(server, rec) -> dict:
    """{(C_p, B, V): launches} of one round: each size group of the batched
    engine runs its padded step count S, one kd_loss_grad call per step on
    (C_p, B, V) logits (C_p its padded client count, B its batch size)."""
    from repro_torch.fl.batched import BatchedClientEngine, next_pow2
    env = server.env
    bpe = env.cfg.batches_per_epoch
    groups = {}
    for c, s, tau in zip(rec.clients, rec.sizes, rec.intensities):
        key = (s, env.loaders[c].batch_size, next_pow2(tau * bpe))
        groups.setdefault(key, []).append(tau * bpe)
    out = {}
    for (_, batch, _), steps in groups.items():
        shape = (BatchedClientEngine._client_pad(len(steps)), batch,
                 env.n_classes)
        out[shape] = out.get(shape, 0) + next_pow2(max(steps))
    return out


def _finite(torch, tree):
    from repro_torch.utils.pytree import tree_leaves
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def phase_main_path(torch):
    from repro_torch.fl import FLEnvironment, HAPFLServer
    from repro_torch.kernels import kd_loss as kd
    env = FLEnvironment(main_path_config())
    server = HAPFLServer(env, engine="batched", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    pre = server.pretrain_rl(10)
    log(f"[main] pretrain_rl(10): straggling {pre[0]['straggling']:.3f} -> "
        f"{pre[-1]['straggling']:.3f}")
    shapes, seconds = {}, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = server.run_round()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        steps = padded_steps(server, rec)
        for shape, n in steps.items():
            shapes[shape] = shapes.get(shape, 0) + n
        log(f"[main] round {rec.round_idx}: {seconds[-1]:.3f} s, sizes "
            f"{rec.sizes}, intensities {rec.intensities}, padded steps by "
            f"(C, B, V) {steps}, straggling {rec.straggling:.3f}, acc_lite "
            f"{rec.acc_lite:.4f}, acc_by_size {rec.acc_by_size}")
    launches = dict(kd.launches)
    log(f"[main] other kernels' launches {all_launches()}")
    expected = {"kd_loss_fwd": 0, "kd_loss_bwd": 0,
                "kd_loss_grad": sum(shapes.values())}
    log(f"[main] launches {launches}, expected {expected}, by (C, B, V) "
        f"{shapes}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: launches {launches} != {expected}: "
                         f"one kd_loss_grad per padded step")
    if not (_finite(torch, server.lite_params)
            and all(_finite(torch, p) for p in server.global_by_size.values())):
        raise SystemExit("chip_smoke: non-finite global params")
    log(f"[main] seconds per round after the first {seconds[1:]}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    return server, launches, shapes


# ---------------------------------------------------------------------- #
# 4b. the paper's baselines and 4c. the event-driven async HAPFL waves
# ---------------------------------------------------------------------- #
BASELINES = ("fedavg", "fedprox", "pfedme", "fedddrl")
BASELINE_ROUNDS = 2       # training rounds per baseline
FEDDDRL_WARMUP = 5        # latency-only rounds first: PPO2's buffer (B = 5)
ASYNC_WAVES = 4


def _host_record(rec):
    """A BaselineRecord's host fields: what the latency model and the data
    streams decide, not the trained params."""
    return (rec.round_idx, sorted(rec.client_acc), rec.straggling,
            rec.wall_time, rec.latency_only)


def phase_baselines(torch):
    """FedAvg, FedProx, pFedMe and FedDdrl (paper §V.B) at the main path's
    config on the card: 2 training rounds each (FedDdrl after 5
    latency-only rounds), finite globals and no kd_loss launch (their loss
    is plain CE). Then one FedProx and one pFedMe round on the card and on
    the CPU from the same globals: identical host records, globals at atol
    1e-4 / rtol 1e-3."""
    from repro_torch.fl import BaselineRunner, FLEnvironment
    from repro_torch.utils.pytree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    reset_all_launches()
    for algo in BASELINES:
        runner = BaselineRunner(FLEnvironment(main_path_config()), algo,
                                device="cuda")
        if algo == "fedddrl":
            for _ in range(FEDDDRL_WARMUP):
                runner.run_round(latency_only=True)
        seconds = []
        for _ in range(BASELINE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = runner.run_round()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            log(f"[baselines] {algo} round {rec.round_idx}: "
                f"{seconds[-1]:.3f} s, straggling {rec.straggling:.3f}, "
                f"acc_global {rec.acc_global:.4f}")
        if not _finite(torch, runner.global_params):
            raise SystemExit(f"chip_smoke: {algo}: non-finite global")
        if algo == "fedddrl" and runner.intensity.agent.n_updates < 1:
            raise SystemExit("chip_smoke: fedddrl: PPO2 never updated")
        log(f"[baselines] {algo}: seconds per round {seconds}, summary "
            f"{runner.summary()}")
    launches = all_launches()
    log(f"[baselines] launches {launches}")
    if any(launches.values()):
        raise SystemExit(f"chip_smoke: the baselines launched kernels "
                         f"{launches}: their CE is no kd_loss")
    for algo in ("fedprox", "pfedme"):
        runners = {dev: BaselineRunner(FLEnvironment(main_path_config()),
                                       algo, device=dev)
                   for dev in ("cuda", "cpu")}
        gpu, cpu = runners["cuda"], runners["cpu"]
        cpu.global_params = tree_map(lambda t: t.cpu(), gpu.global_params)
        if algo == "pfedme":
            cpu.personal = {c: cpu.global_params for c in cpu.personal}
        with full_fp32(torch):
            recs = {dev: r.run_round() for dev, r in runners.items()}
            torch.cuda.synchronize()
        if _host_record(recs["cuda"]) != _host_record(recs["cpu"]):
            raise SystemExit(f"chip_smoke: {algo}: card and CPU records "
                             f"differ: {recs}")
        err = 0.0
        for a, b in zip(tree_leaves(gpu.global_params),
                        tree_leaves(cpu.global_params)):
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-3)
            err = max(err, float((a.cpu() - b).abs().max()))
        log(f"[baselines] {algo} cuda vs cpu: host records identical, "
            f"globals max|diff| {err:.3e} (atol 1e-4, rtol 1e-3)")
    wall = time.perf_counter() - t_phase
    log(f"[baselines] phase wall {wall:.2f} s")
    return wall


def _globals_equal(torch, a, b):
    from repro_torch.utils.pytree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves([a.lite_params, a.global_by_size]),
        tree_leaves([b.lite_params, b.global_by_size])))


def phase_async(torch, grad_errs):
    """examples/comm_efficient.py's setup on the main path's config: a
    HAPFL server with cross-size aggregation and the topk+int8 codec under
    the buffered policy (buffer 3) with codec-priced links, fleet health and
    the tracer on, 4 waves. Counters are zeroed just before and read just
    after: one kd_loss_grad per padded step of every wave. Every wave's
    record carries rl_diag; each client's uplink is under a quarter of its
    dense float32 bytes; the first aggregation moves both sizes' globals.
    Then, on the card: codec="identity" equals no codec bit for bit for a
    round, and the sync policy's 2 waves equal server.run(2). Each
    (C, B, V) the waves gave kd_loss_grad is held against its plain version
    (phase_kd_grad) unless phase 3 did."""
    from repro_torch.comm import make_codec
    from repro_torch.core.latency import make_comm_model
    from repro_torch.core.nested import covers_all
    from repro_torch.fl import FLEnvironment, HAPFLServer
    from repro_torch.kernels import kd_loss as kd
    from repro_torch.obs import trace
    from repro_torch.sim import BufferedPolicy, EventScheduler, SyncPolicy
    from repro_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    env = FLEnvironment(main_path_config())
    codec = make_codec("topk+int8", ratio=0.08, dense_min=256)
    server = HAPFLServer(env, aggregation="cross_size", codec=codec,
                         device="cuda")
    comm = make_comm_model(
        {s: float(c.num_params()) for s, c in env.pool.items()},
        float(env.lite_cfg.num_params()), env.cfg.n_clients, codec=codec,
        model_tensors={s: c.num_tensors() for s, c in env.pool.items()},
        lite_tensors=env.lite_cfg.num_tensors())
    if covers_all(env.pool["large"], env.pool["small"]):
        raise SystemExit("chip_smoke: small covers large: the coverage-class "
                         "path would not run")
    before = {s: [t.clone() for t in tree_leaves(p)]
              for s, p in server.global_by_size.items()}
    moved, apply, wave_s = [], server.apply_updates, []

    def first_moves(*a, **k):
        n = apply(*a, **k)
        if not moved:
            moved.append({s: any(not torch.equal(x, y) for x, y in zip(
                before[s], tree_leaves(server.global_by_size[s])))
                for s in before})
        return n
    server.apply_updates = first_moves
    train = server.train_wave

    def timed_train(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(*a, **k)
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
        return out
    server.train_wave = timed_train
    sched = EventScheduler(server, BufferedPolicy(buffer_m=3), comm=comm,
                           health=True)
    tracer = trace.enable()
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        res = sched.run(waves=ASYNC_WAVES)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(kd.launches)
    finally:
        trace.disable()
    server.apply_updates, server.train_wave = apply, train
    shapes = {}
    for rec in server.history:
        for shape, n in padded_steps(server, rec).items():
            shapes[shape] = shapes.get(shape, 0) + n
    expected = {"kd_loss_fwd": 0, "kd_loss_bwd": 0,
                "kd_loss_grad": sum(shapes.values())}
    log(f"[async] {res.summary()}")
    log(f"[async] {len(server.history)} waves in {run_s:.3f} s; train_wave "
        f"(training + codec round trip + client eval) seconds {wave_s}; "
        f"timing {res.timing}; trace events {len(tracer.events)}")
    log(f"[async] launches {launches}, expected {expected}, by (C, B, V) "
        f"{shapes}")
    if len(server.history) != ASYNC_WAVES or launches != expected:
        raise SystemExit(f"chip_smoke: async waves: launches {launches} != "
                         f"{expected}: one kd_loss_grad per padded step")
    if any(rec.rl_diag is None or set(rec.rl_diag) != {"ppo1", "ppo2"}
           for rec in server.history):
        raise SystemExit("chip_smoke: a traced wave has no rl_diag")
    log(f"[async] rl_diag of the last wave {server.history[-1].rl_diag}")
    ratios = []
    for info in sched._waves.values():
        plan = info["plan"]
        for c, s, wire in zip(plan.clients, plan.sizes, plan.wire_bytes):
            dense = 4.0 * (env.pool[s].num_params()
                           + env.lite_cfg.num_params())
            ratios.append(wire / dense)
    log(f"[async] wire bytes / dense float32 bytes per client: min "
        f"{min(ratios):.4f}, max {max(ratios):.4f} over {len(ratios)} "
        f"uploads; up_bytes {res.up_bytes}")
    if len(ratios) != res.n_updates or max(ratios) >= 0.25:
        raise SystemExit("chip_smoke: an upload is not under a quarter of "
                         "its dense bytes")
    if not moved or not all(moved[0].values()):
        raise SystemExit(f"chip_smoke: the first aggregation left a size's "
                         f"global unmoved: {moved}")
    if not (_finite(torch, server.lite_params)
            and all(_finite(torch, p) for p in server.global_by_size.values())):
        raise SystemExit("chip_smoke: async waves: non-finite globals")
    log(f"[async] first aggregation moved {moved[0]}; globals finite")

    # identity codec == no codec, and the sync policy == run(), on the card
    servers = [HAPFLServer(FLEnvironment(main_path_config()), seed=5,
                           codec=cd, device="cuda")
               for cd in (None, "identity")]
    recs = [srv.run_round() for srv in servers]
    same = (recs[0].clients, recs[0].sizes, recs[0].intensities,
            recs[0].acc_lite, recs[0].client_acc) == (
        recs[1].clients, recs[1].sizes, recs[1].intensities,
        recs[1].acc_lite, recs[1].client_acc)
    if not (same and _globals_equal(torch, *servers)):
        raise SystemExit("chip_smoke: codec='identity' is not bitwise "
                         "codec=None on the card")
    log("[async] codec='identity' == codec=None bit for bit (one round)")
    plain = HAPFLServer(FLEnvironment(main_path_config()), seed=6,
                        device="cuda")
    plain.run(2)
    synced = HAPFLServer(FLEnvironment(main_path_config()), seed=6,
                         device="cuda")
    EventScheduler(synced, SyncPolicy()).run(waves=2)
    for a, b in zip(plain.history, synced.history):
        if (dataclasses.asdict(a) != dataclasses.asdict(b)):
            raise SystemExit(f"chip_smoke: the sync policy's records differ "
                             f"from server.run's: {a} vs {b}")
    if len(synced.history) != 2 or not _globals_equal(torch, plain, synced):
        raise SystemExit("chip_smoke: the sync policy's globals are not "
                         "server.run's bit for bit")
    log("[async] EventScheduler(SyncPolicy()).run(waves=2) == "
        "server.run(2): records identical, globals bit for bit")
    grad_errs.update(phase_kd_grad(
        torch, [(C, B, V, "float32") for C, B, V in sorted(shapes)
                if (C, B, V, "float32") not in grad_errs]))
    wall = time.perf_counter() - t_phase
    log(f"[async] phase wall {wall:.2f} s")
    return launches, shapes, wall


# ---------------------------------------------------------------------- #
# 4d. the parameter service
# ---------------------------------------------------------------------- #
# launch/serve.py's defaults (mnist, 16 clients, k 4, async, churn, 400
# Poisson events at 2 Hz) with the topk+int8 codec; the kill/restore pin
# cuts the trace at event 200
SERVICE = {"n_clients": 16, "k": 4, "events": 400, "rate_hz": 2.0,
           "seed": 0, "codec": "topk+int8", "cut": 200}


def _service_argv(ckpt_dir, out_dir=None):
    argv = ["--n-clients", str(SERVICE["n_clients"]),
            "--k-per-round", str(SERVICE["k"]), "--policy", "async",
            "--codec", SERVICE["codec"], "--events", str(SERVICE["events"]),
            "--rate-hz", str(SERVICE["rate_hz"]),
            "--seed", str(SERVICE["seed"]), "--device", "cuda",
            "--checkpoint-dir", str(ckpt_dir),
            "--metrics-out", str(Path(ckpt_dir).parent / "metrics.json")]
    if out_dir is not None:
        argv += ["--health-report", str(out_dir / "health.md"),
                 "--prom-out", str(out_dir / "metrics.prom"),
                 "--events-jsonl", str(out_dir / "events.jsonl")]
    return argv


def _run_main(main, argv):
    """main(argv) with its standard output captured and logged; returns
    (the service, the output, seconds)."""
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        svc = main(argv)
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"[service]   | {line}")
    return svc, buf.getvalue(), seconds


def service_state_diff(torch, ref, other):
    """The fields on which two services differ, of everything a restored
    service must carry over bit for bit: globals, LiteModel, both PPO
    agents (params, AdamW state, buffer, pending transition, rewards), the
    server's generator, EF residuals, env rng, records, the deterministic
    counters, the staleness histogram and the byte counts."""
    import numpy as np
    from repro_torch.utils.pytree import tree_leaves

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(
            torch.equal(torch.as_tensor(x), torch.as_tensor(y))
            for x, y in zip(la, lb))
    a, b = ref.server, other.server
    checks = {
        "lite": same(a.lite_params, b.lite_params),
        "globals": same(a.global_by_size, b.global_by_size),
        "generator": torch.equal(a.gen.get_state(), b.gen.get_state()),
        "ef": (sorted(a._ef) == sorted(b._ef)
               and all(same(a._ef[k], b._ef[k]) for k in a._ef)),
        "env_rng": (a.env.rng.bit_generator.state
                    == b.env.rng.bit_generator.state),
        "version": ref.version == other.version,
        "records": ref.records == other.records,
        "counts": (ref.metrics.deterministic_counts()
                   == other.metrics.deterministic_counts()),
        "staleness": (dict(ref.metrics.staleness)
                      == dict(other.metrics.staleness)),
        "bytes": ((ref.metrics.up_bytes, ref.metrics.down_bytes)
                  == (other.metrics.up_bytes, other.metrics.down_bytes)),
    }
    for name, oa, ob in (("ppo1", a.allocator, b.allocator),
                         ("ppo2", a.intensity, b.intensity)):
        ea, eb = oa.agent, ob.agent
        checks[f"{name}.params"] = same(ea.params, eb.params)
        checks[f"{name}.opt"] = same(ea.opt_state, eb.opt_state)
        checks[f"{name}.buffer"] = len(ea.buffer) == len(eb.buffer) and all(
            list(x) == list(y) and all(np.array_equal(x[k], y[k]) for k in x)
            for x, y in zip(ea.buffer, eb.buffer))
        checks[f"{name}.rewards"] = ea.reward_history == eb.reward_history
        checks[f"{name}.pending"] = (
            set(oa._pending) == set(ob._pending)
            and all(np.array_equal(oa._pending[k], ob._pending[k])
                    for k in oa._pending))
    return sorted(k for k, ok in checks.items() if not ok)


def _wire_over_dense(svc):
    """Uplink wire bytes over the dense float32 bytes of the same
    submitted updates (each submit's size from its dispatch event)."""
    env = svc.server.env
    sizes, dense = {}, 0.0
    for ev in svc.metrics.events:
        if ev["event"] == "dispatch":
            sizes[(ev["client"], ev["wave"])] = ev["size"]
        elif ev["event"] == "submit":
            size = sizes[(ev["client"], ev["wave"])]
            dense += 4.0 * (env.pool[size].num_params()
                            + env.lite_cfg.num_params())
    return svc.metrics.up_bytes / dense


def phase_service(torch):
    """launch/serve.py's main on the card twice over one checkpoint
    directory (the second must resume), then the kill/restore pin of the
    buffered service for the identity and topk+int8 codecs, bitwise on the
    card; updates/s, dispatch and submit latency, checkpoint save and
    restore time and bytes, and wire bytes over dense are logged. The
    service trains nothing: every kernel's count must stay 0."""
    import tempfile
    from repro_torch.launch import serve
    from repro_torch.service import LoadGenerator, poisson_trace
    t_phase = time.perf_counter()
    reset_all_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_service_") as tmp:
        tmp = Path(tmp)
        ckpt_dir = tmp / "ckpt"
        svc, out, first_s = _run_main(serve.main,
                                      _service_argv(ckpt_dir, tmp))
        torch.cuda.synchronize()
        snap = svc.metrics.snapshot()
        missing = [n for n in ("metrics.json", "health.md", "health.json",
                               "metrics.prom", "events.jsonl")
                   if not (tmp / n).is_file() or not (tmp / n).stat().st_size]
        if "resumed" in out or missing or svc.server.device.type != "cuda":
            raise SystemExit(f"chip_smoke: serve.main: resumed on a fresh "
                             f"directory, or outputs missing {missing}")
        log(f"[service] serve.main on {svc.server.device}: {first_s:.2f} s, "
            f"version {svc.version}, updates/s {snap['updates_per_sec']}, "
            f"dispatch {snap['dispatch']}, submit {snap['submit']}, "
            f"checkpoint {snap['checkpoint']}, staleness "
            f"{snap['staleness_hist']}; wire / dense bytes "
            f"{_wire_over_dense(svc):.4f} (up {svc.metrics.up_bytes}, down "
            f"{svc.metrics.down_bytes})")
        again, out, again_s = _run_main(serve.main, _service_argv(ckpt_dir))
        torch.cuda.synchronize()
        want = f"resumed from {ckpt_dir}/ckpt-{svc.version:08d}"
        if want not in out or again.version <= svc.version:
            raise SystemExit(f"chip_smoke: the second serve.main did not "
                             f"resume ({want!r} not printed)")
        log(f"[service] second serve.main resumed at version {svc.version} "
            f"and reached {again.version} in {again_s:.2f} s")

        trace = poisson_trace(SERVICE["events"], SERVICE["n_clients"],
                              SERVICE["rate_hz"], seed=SERVICE["seed"])
        cut = SERVICE["cut"]
        for codec in ("identity", SERVICE["codec"]):
            def build():
                return serve.build_service(
                    SERVICE["n_clients"], SERVICE["k"], "buffered", codec,
                    SERVICE["seed"],
                    min_deadline=1.5 * SERVICE["n_clients"]
                    / SERVICE["rate_hz"],
                    horizon=SERVICE["events"] / SERVICE["rate_hz"],
                    device="cuda")
            t_pin = time.perf_counter()
            ref = build()
            t0 = time.perf_counter()
            LoadGenerator(ref, trace, seed=SERVICE["seed"]).replay()
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            first = build()
            LoadGenerator(first, trace, seed=SERVICE["seed"]).replay(
                stop=cut)
            in_flight = (len(first.tickets), len(first.buffer),
                         len(first._waves))
            t0 = time.perf_counter()
            path = first.checkpoint(str(tmp / f"pin-{codec}"))
            save_s = time.perf_counter() - t0
            nbytes = sum(Path(path + ext).stat().st_size
                         for ext in (".npz", ".json", ".aux.json"))
            del first                                  # the "kill"
            second = build()
            t0 = time.perf_counter()
            second.restore(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            LoadGenerator(second, trace, seed=SERVICE["seed"]).replay(
                start=cut)
            torch.cuda.synchronize()
            diff = service_state_diff(torch, ref, second)
            ppo = (ref.server.allocator.agent.n_updates,
                   ref.server.intensity.agent.n_updates)
            log(f"[service] kill/restore pin, buffered, codec {codec}: "
                f"uninterrupted {ref_s:.2f} s to version {ref.version} "
                f"(PPO updates {ppo}); checkpoint at event {cut} with "
                f"(tickets, buffered, open waves) {in_flight}: save "
                f"{save_s * 1e3:.1f} ms, restore {restore_s * 1e3:.1f} ms, "
                f"{nbytes} B; restored run differs in {diff or 'nothing'}; "
                f"{time.perf_counter() - t_pin:.2f} s for the three runs")
            if diff or min(ppo) < 1:
                raise SystemExit(f"chip_smoke: the restored service is not "
                                 f"the uninterrupted one bit for bit "
                                 f"({diff}), or PPO never updated {ppo}")
        t0 = time.perf_counter()
        profile_service(torch, build, trace[:cut])
        log(f"[service] profiles {time.perf_counter() - t0:.2f} s")
    launches = all_launches()
    if any(launches.values()):
        raise SystemExit(f"chip_smoke: the service launched kernels "
                         f"{launches}: it trains nothing")
    wall = time.perf_counter() - t_phase
    log(f"[service] launches {launches}; phase wall {wall:.2f} s")
    return wall


def profile_service(torch, build, trace):
    """Where a replay's host time goes (cProfile: the top functions by
    their own time) and how busy its first 60 events keep the card
    (torch.profiler, whose own cost grows with the events it records)."""
    import cProfile
    import pstats
    from repro_torch.service import LoadGenerator
    svc = build()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(LoadGenerator(svc, trace, seed=SERVICE["seed"]).replay)
    torch.cuda.synchronize()
    log(f"[service] profile: {len(trace)} events in "
        f"{time.perf_counter() - t0:.2f} s under cProfile; own time by "
        f"function:")
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:14]
    for (path, line, fn), (_, calls, own, cum, _) in rows:
        log(f"[service]   {own:8.3f} s own {cum:8.3f} s cum {calls:7d}x "
            f"{Path(path).name}:{line}({fn})")
    svc = build()
    trace = trace[:60]
    phase_profile(torch, f"service replay ({len(trace)} events)",
                  LoadGenerator(svc, trace, seed=SERVICE["seed"]).replay, ())


def reset_all_launches():
    from repro_torch.kernels import (adamw, decode_attention,
                                     flash_attention, kd_loss, rmsnorm)
    for mod in (kd_loss, rmsnorm, flash_attention, adamw, decode_attention):
        mod.reset_launches()


def all_launches():
    from repro_torch.kernels import (adamw, decode_attention,
                                     flash_attention, kd_loss, rmsnorm)
    return {**kd_loss.launches, **rmsnorm.launches, **flash_attention.launches,
            **adamw.launches, **decode_attention.launches}


#: the optimizer's kernels (kernels/adamw.py), which every training step on
#: the card launches (`optimizer_launches`)
OPT_KERNELS = ("sumsq", "sumsq_finish", "adamw")


def optimizer_launches(numels, clip=True):
    """{kernel: launches} of one training step's optimizer on CUDA leaves of
    these lengths: `global_norm` (when the step clips) one sumsq a group of
    leaves (`kernels.adamw.groups`) and one sumsq_finish, then `update_` one
    adamw a group."""
    from repro_torch.kernels.adamw import groups
    n = len(groups(numels))
    return {"sumsq": n if clip else 0, "sumsq_finish": int(bool(clip)),
            "adamw": n}


# ---------------------------------------------------------------------- #
# 5. the serve path: llama3.2-3b at full width
# ---------------------------------------------------------------------- #
def block_norms(cfg):
    """(the norms of one forward's blocks, its attention calls): two norms
    and one attention a block in an attention stack; one norm an SSM block
    (xLSTM, Mamba2); zamba2's Mamba2 blocks one each and its shared block,
    run once after each segment, two norms and one attention a run."""
    from repro_torch.models.transformer import zamba_layout
    if cfg.block_kind == "attention":
        return 2 * cfg.n_layers, cfg.n_layers
    if cfg.shared_attn_every:
        n_seg = zamba_layout(cfg)[0]
        return cfg.n_layers + 2 * n_seg, n_seg
    return cfg.n_layers, 0


def serve_launch_shapes(cfg):
    """{kernel: {shape: launches}} of one counted generate: every forward
    runs one rmsnorm (the first block's first norm) and N add_rmsnorm
    (every other norm of its N block norms, each with the residual add
    before it, and the final norm), the last of which, before the
    unembedding, prefill applies to the last position only; prefill runs
    flash attention once per attention call, each decode step the decode
    attention once per attention call. A layernorm config (musicgen, xlstm)
    launches no norm kernel, an attention-free one (xlstm) no attention
    kernel."""
    B, S, n = SERVE["batch"], SERVE["prompt"], SERVE["n_new"]
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    N, A = block_norms(cfg)
    dt = str(cfg.dtype).removeprefix("torch.")
    rms = cfg.norm == "rmsnorm"
    return {"rmsnorm": {(B * S, d, dt): 1, (B, d, dt): n} if rms else {},
            "add_rmsnorm": {(B * S, d, dt): N - 1,
                            (B, d, dt): 1 + N * n} if rms else {},
            "flash_attention": {(B, H, KV, S, cfg.resolved_head_dim, 0,
                                 dt, "bshd"): A} if A else {},
            "decode_attention": {decode_shape(cfg, B, SERVE["max_len"]):
                                 A * n} if A else {},
            "kd_loss_fwd": {}, "kd_loss_bwd": {}, "kd_loss_grad": {},
            "rmsnorm_bwd": {}, "add_rmsnorm_bwd": {},
            "flash_attention_bwd": {}, "sumsq": {}, "sumsq_finish": {},
            "adamw": {}}


def block_layout(cfg):
    """The block layout of an xLSTM or hybrid config, in words."""
    from repro_torch.models.transformer import xlstm_layout, zamba_layout
    if cfg.block_kind == "xlstm":
        g, m_per, tail = xlstm_layout(cfg)
        return (f"{g} groups of {m_per} mLSTM + 1 sLSTM blocks and a tail of "
                f"{tail} mLSTM")
    n_seg, seg, tail = zamba_layout(cfg)
    return (f"{n_seg} segments of {seg} Mamba2 blocks, each followed by the "
            f"shared attention + MLP block, and a tail of {tail} Mamba2")


def serve_batch(torch, cfg, B, S, seed):
    """A prompt batch of `cfg`'s inputs on the card: (B, S) tokens, an audio
    model's (B, S, nq) codebook tokens (numpy draws), or a VLM's (B, S, d)
    N(0, 1) patch embeddings in cfg.dtype with (3, B, S) positions (t, t //
    8, t % 8) from a seeded generator on the card (dummy_batch)."""
    import numpy as np
    from repro_torch.models.api import dummy_batch
    if cfg.input_mode == "embeddings":
        return dummy_batch(cfg, B, S, torch.Generator("cuda").manual_seed(seed),
                           with_labels=False, device="cuda")
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    return {"tokens": torch.as_tensor(tokens, device="cuda")}


def eager_decode(torch, engine, batch, n_new):
    """The engine's decode step run eagerly: the same prefill and cache set-up
    as `generate`, then n_new calls of make_decode_step's function with a 0-d
    position tensor. Returns the tokens (B, n_new[, nq]) numpy, each step's
    logits (B, n_new[, nq], vocab) and the wall seconds of the decode
    loop."""
    from repro_torch.models.api import make_decode_cache
    from repro_torch.serve import (decode_batch, make_decode_step,
                                   make_prefill_step)
    from repro_torch.serve.engine import _load_prefill
    cfg, params = engine.cfg, engine.params
    B, S = batch["embeddings" if cfg.input_mode == "embeddings"
                 else "tokens"].shape[:2]
    step = make_decode_step(cfg)
    with torch.no_grad():
        logits, pre = make_prefill_step(cfg)(params, batch)
        cache = make_decode_cache(cfg, B, engine.max_len, "cuda")
        _load_prefill(cache, pre,       # as generate pairs them
                      carry=cfg.carry_prompt_state)
        del pre
        tok = logits[:, -1].argmax(-1)
        index = torch.zeros((), dtype=torch.int64, device="cuda")
        toks, kept = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_new):
            index.fill_(S + i)
            tok, lg, cache = step(params, decode_batch(cfg, params,
                                                       tok[:, None]),
                                  cache, index)
            toks.append(tok)
            kept.append(lg[:, -1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return torch.stack(toks, 1).cpu().numpy(), torch.stack(kept, 1), secs


def check_graph_is_eager(torch, engine, batch, n_new, what, tag="serve"):
    """engine.generate (the captured decode step, replayed) against the
    eager loop of the same step from the same prefill: identical tokens and
    bitwise equal logits at every step. Returns the eager loop's seconds."""
    import numpy as np
    got, logits = engine.generate(batch, n_new=n_new, return_logits=True)
    toks, kept, secs = eager_decode(torch, engine, batch, n_new)
    same = [bool(torch.equal(logits[:, i], kept[:, i]))
            for i in range(n_new)]
    if not (np.array_equal(got, toks) and all(same)):
        diffs = [float((logits[:, i] - kept[:, i]).abs().max())
                 for i in range(n_new)]
        raise SystemExit(f"chip_smoke: {what}: the graphed generate differs "
                         f"from the eager decode loop: tokens equal "
                         f"{np.array_equal(got, toks)}, max|diff| of logits "
                         f"per step {diffs}")
    log(f"[{tag}] {what}: graphed generate == eager decode loop: tokens "
        f"identical, logits bitwise equal at all {n_new} steps")
    return secs


def phase_serve(torch, cfg=None, tag="serve"):
    """Serve 4 x 512-token prompts (serve_batch: tokens, codebook tokens or
    patch embeddings) for 32 new tokens with `cfg` (SERVE's arch when
    None); returns the engine, its batch, the counted launches,
    the expected shapes and the measured times."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model, prefill
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.pytree import tree_leaves
    cfg = cfg or get_config(SERVE["arch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_model(torch.Generator("cuda").manual_seed(SERVE["seed"]),
                        cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    ffn = (f"{cfg.n_experts} experts, top-{cfg.top_k}, moe_d_ff "
           f"{cfg.moe_d_ff}, capacity_factor {cfg.capacity_factor}"
           if cfg.is_moe else f"d_ff {cfg.d_ff}")
    if cfg.block_kind == "xlstm":
        ffn = (f"{block_layout(cfg)}, no attention (d_ff {cfg.d_ff}: the "
               f"blocks carry their own projections)")
    elif cfg.family == "hybrid":
        ffn = f"{block_layout(cfg)}, ssm_state {cfg.ssm_state}, " + ffn
    io = (f"patch embeddings, M-RoPE sections {cfg.mrope_sections}"
          if cfg.input_mode == "embeddings" else
          f"{cfg.n_codebooks} codebooks" if cfg.n_codebooks else "tokens")
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, hd "
        f"{cfg.resolved_head_dim}, {ffn}, {cfg.norm}, vocab "
        f"{cfg.vocab_size}, {io}, {cfg.dtype}; {n_params} parameters "
        f"(num_params() {cfg.num_params()} + norm scales), "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params))} "
        f"B, initialised in {time.perf_counter() - t0:.2f} s")
    B, S, n_new = SERVE["batch"], SERVE["prompt"], SERVE["n_new"]
    batch = serve_batch(torch, cfg, B, S, SERVE["seed"])
    engine = ServeEngine(cfg, params, max_len=SERVE["max_len"], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(batch, n_new=2)   # captures the decode step; warm-up
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    step = engine.decode_step_for(B)
    if step.graph is None:
        raise SystemExit(f"chip_smoke: {tag}: the engine's decode step on "
                         f"the card is not a CUDA graph")
    log(f"[{tag}] first generate(2), the decode step's capture included: "
        f"{first:.4f} s; launches per replay {step.launches}")

    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    out = engine.generate(batch, n_new=n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()

    shapes = serve_launch_shapes(cfg)
    expected = {k: sum(v.values()) for k, v in shapes.items()}
    log(f"[{tag}] launches {launches}, expected {expected}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: {tag} launches {launches} != "
                         f"{expected}")
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if (out.shape != (B, n_new) + nq or out.min() < 0
            or out.max() >= cfg.vocab_size):
        raise SystemExit(f"chip_smoke: generate gave {out.shape} tokens in "
                         f"[{out.min()}, {out.max()}]")
    with torch.no_grad():
        logits, _ = prefill(params, cfg, batch)
    if logits.shape != (B, 1) + nq + (cfg.vocab_size,) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit("chip_smoke: prefill logits are not finite of "
                         "shape (B, 1[, nq], vocab)")
    eager_s = check_graph_is_eager(torch, engine, batch, n_new,
                                   f"{cfg.name} at full width", tag)
    check_decode_reads_in_place(torch, engine, B, tag, block_norms(cfg)[1])
    # prefill + one decode step, and 31 more decode steps: the difference
    # is the decode time per token
    runs = {}
    for n in (1, n_new, n_new, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(batch, n_new=n)
        torch.cuda.synchronize()
        runs.setdefault(n, []).append(time.perf_counter() - t0)
    t1, tn = (sum(runs[n]) / 2 for n in (1, n_new))
    decode_ms = (tn - t1) / (n_new - 1) * 1e3
    prefill_ms = t1 * 1e3 - decode_ms
    eager_ms = [eager_s * 1e3 / n_new,
                eager_decode(torch, engine, batch, n_new)[2] * 1e3 / n_new]
    # the graph's own device time per step: replays timed by CUDA events
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n_new):
        step.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / n_new
    # and generate's decode loop alone, host included, by the wall clock:
    # free of the prefill's spread, which the difference above carries
    t0 = time.perf_counter()
    decode_loop(torch, engine, S, n_new)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / n_new
    log(f"[{tag}] counted generate {wall:.4f} s; generate(1) {runs[1]} s, "
        f"generate({n_new}) {runs[n_new]} s -> prefill {prefill_ms:.3f} ms "
        f"({B * S / prefill_ms * 1e3:.0f} prompt tokens/s), decode "
        f"{decode_ms:.3f} ms per step of {B} tokens graphed (graph replay "
        f"device time {replay_ms:.3f} ms per step; the decode loop alone "
        f"{loop_ms:.3f} ms per step by the wall clock), eager decode loop "
        f"{eager_ms[0]:.3f} and {eager_ms[1]:.3f} ms per step; "
        f"{B * n_new / tn:.1f} generated tokens/s over generate({n_new}); "
        f"max_memory_allocated {peak} B; first row {out[0][:8].tolist()}")
    measured = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                "replay_ms": replay_ms, "loop_ms": loop_ms,
                "eager_ms": eager_ms,
                "tokens_per_s": B * n_new / tn, "peak_bytes": peak}
    PATHS[tag] = {"cfg": cfg, "mode": "serve", "launches": dict(launches),
                  "prefill_ms": prefill_ms, "decode_ms": decode_ms,
                  "replay_ms": replay_ms}
    return engine, batch, launches, shapes, measured


def phase_serve_wrap(torch):
    """A 2-layer cut of the full-width config with a sliding window: the
    graphed generate crosses the ring buffer's wrap and still equals the
    eager decode loop bit for bit."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_config(SERVE["arch"]),
                              n_layers=WRAP["n_layers"],
                              sliding_window=WRAP["window"])
    params = init_model(torch.Generator("cuda").manual_seed(3), cfg, "cuda")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE["batch"], WRAP["prompt"]))
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    engine = ServeEngine(cfg, params, max_len=SERVE["max_len"], device="cuda")
    ring = engine.decode_step_for(SERVE["batch"]).cache["blocks"]["k"]
    last = WRAP["prompt"] + WRAP["n_new"] - 1
    if not (ring.shape[2] == WRAP["window"] < last):
        raise SystemExit(f"chip_smoke: the ring buffer {tuple(ring.shape)} "
                         f"does not wrap before position {last}")
    check_graph_is_eager(
        torch, engine, batch, WRAP["n_new"],
        f"{WRAP['n_layers']}-layer cut, window {WRAP['window']}, positions "
        f"{WRAP['prompt']}..{last} (the ring wraps at {WRAP['window']})")


def phase_serve_parity(torch):
    """A 2-layer fp32 cut of the full-width config, the same weights on the
    card and on the CPU: prefill logits and 4 decode steps' logits, each
    step fed the CPU's greedy token on both sides."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.api import (decode_step, init_model,
                                        make_decode_cache, prefill)
    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=2,
                              dtype=torch.float32)
    B, S, steps = 2, 128, 4
    gpu = init_model(torch.Generator("cuda").manual_seed(1), cfg, "cuda")
    sides = {"cuda": gpu,
             "cpu": params_from_numpy(params_to_numpy(gpu), device="cpu")}
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    err, agree = 0.0, 0
    with full_fp32(torch), torch.no_grad():
        logits, caches = {}, {}
        for dev, params in sides.items():
            logits[dev], pre = prefill(params, cfg, {
                "tokens": torch.as_tensor(tok, device=dev)})
            caches[dev] = make_decode_cache(cfg, B, S + steps, dev)
            for key in ("k", "v"):
                caches[dev]["blocks"][key][:, :, :S] = pre["blocks"][key]
        for i in range(steps + 1):
            a, b = logits["cuda"].cpu(), logits["cpu"]
            # fp32 on both sides, summed in other orders over rows of
            # 3072-8192: ten times the 1e-4 the CPU port keeps to the JAX
            # reference at the smoke config's d 256
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
            err = max(err, float((a - b).abs().max()))
            nxt = b[:, -1].argmax(-1)
            agree += int((a[:, -1].argmax(-1) == nxt).sum())
            if i == steps:
                break
            for dev, params in sides.items():
                logits[dev], caches[dev] = decode_step(
                    params, cfg, {"tokens": nxt[:, None].to(dev)},
                    caches[dev], S + i)
    log(f"[parity] serve, 2-layer fp32 cut at full width, B {B}, S {S}: "
        f"prefill + {steps} decode steps, max|diff| of logits {err:.3e} "
        f"(atol 1e-3, rtol 1e-3); greedy tokens agree {agree} of "
        f"{B * (steps + 1)}")


# ---------------------------------------------------------------------- #
# 5c and 5d. the MoE family: qwen3-moe-30b-a3b served at full width and
# depth, and a 2-layer fp32 cut of it on the card against the CPU
# ---------------------------------------------------------------------- #
def decode_bound_ms(torch, engine, B=None):
    """The least time of one decode step: every parameter read once (of an
    untied embedding table only the B rows a step gathers from it; a tied
    one is the head too, read whole; an MoE decode reads every expert, as
    the reference's capacity dispatch runs all of them), the whole KV cache
    read once, and every recurrent state (an SSM's: the mLSTM's C, n, m,
    the sLSTM's h, c, n, m, Mamba2's conv and ssm) read and written once,
    over the card's memory rate. A hybrid's shared attention + MLP block
    runs once per segment (zamba2-7b: 13 times a step), and its weights
    (0.411 GB at full width) do not stay in the 50 MB L2 from one
    invocation to the next, so they count once per invocation; the bound
    with them counted once is logged beside it. So do Zamba2-7B-Instruct's
    two shared blocks (0.668 GB each) at each of their 13 calls. B is the
    decode batch (SERVE's when None). Returns (bytes, ms, the cache's
    bytes)."""
    from repro_torch.models.transformer import zamba_layout
    from repro_torch.utils.pytree import tree_leaves
    params, cfg = engine.params, engine.cfg
    B = B or SERVE["batch"]
    emb = params["io"]["embed"]
    rows = B * (cfg.n_codebooks or 1)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    if not cfg.tie_embeddings:
        nbytes += (rows * emb.shape[-1] - emb.numel()) * emb.element_size()
    cache = engine.decode_step_for(B).cache
    kv = [t for path, t in _leaf_paths(cache) if path[-1] in ("k", "v")]
    state = [t for path, t in _leaf_paths(cache) if path[-1] not in ("k",
                                                                     "v")]
    cache_bytes = sum(t.numel() * t.element_size() for t in kv + state)
    nbytes += (sum(t.numel() * t.element_size() for t in kv)
               + 2 * sum(t.numel() * t.element_size() for t in state))
    if cfg.shared_attn_every or cfg.family == "zamba2":
        n_seg, blocks = ((zamba_layout(cfg)[0], 1) if cfg.shared_attn_every
                         else (len(cfg.hybrid_layer_ids), cfg.shared_blocks))
        shared = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params["shared"]))
        once = nbytes
        nbytes += (n_seg - blocks) * shared // blocks
        log(f"[{cfg.family} serve] decode byte bound with the shared "
            f"blocks' {shared} B of weights counted once: {once} B, "
            f"{once / HW['hbm_bw'] * 1e3:.3f} ms; counted at each of its "
            f"{n_seg} invocations: {nbytes} B, "
            f"{nbytes / HW['hbm_bw'] * 1e3:.3f} ms (the bound used)")
    return nbytes, nbytes / HW["hbm_bw"] * 1e3, cache_bytes


def _leaf_paths(tree, path=()):
    """[(key path, leaf)] of a tree of dicts."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaf_paths(tree[k], path + (k,))]
    return [(path, tree)]


def phase_moe_serve(torch):
    """Phase 5's serve path on qwen3-moe-30b-a3b at full width and depth:
    the exact launches, graphed == eager bit for bit, the times, the
    prefill's dropped share, the decode step's byte bound and a profiled
    graphed decode loop. Returns the launches, the expected shapes, the
    times and the phase's wall seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import dispatch_slots
    from repro_torch.models.transformer import apply_blocks
    t_phase = time.perf_counter()
    free_device_memory(torch)
    free, total = torch.cuda.mem_get_info()
    log(f"[moe serve] free device memory before init {free} B of {total} B; "
        f"allocated {torch.cuda.memory_allocated()} B")
    cfg = get_config(MOE["arch"])
    engine, batch, launches, shapes, measured = phase_serve(
        torch, cfg, "moe serve")
    L = cfg.n_layers
    calls, side = {"cuda": []}, ["cuda"]
    with torch.no_grad(), recorded_routes(calls, side):
        _, _, _, aux = apply_blocks(engine.params, cfg, batch, cache="init")
    measured.update({k: float(v) / L for k, v in aux.items()})
    # each layer's dropped share, and the share of tokens whose top-1
    # expert is that layer's most common one
    C = expert_capacity_of(cfg, SERVE["batch"] * SERVE["prompt"])
    per_layer = []
    for _, top_i in calls["cuda"]:
        _, keep = dispatch_slots(top_i, cfg.n_experts, C)
        top1 = top_i[:, 0].bincount(minlength=cfg.n_experts)
        per_layer.append((1 - float(keep.float().mean()),
                          float(top1.max()) / top_i.shape[0]))
    log(f"[moe serve] prefill, layer by layer: dropped share "
        f"{[round(d, 4) for d, _ in per_layer]}; share of tokens on the "
        f"layer's most common top-1 expert "
        f"{[round(t, 4) for _, t in per_layer]}")
    nbytes, bound, _ = decode_bound_ms(torch, engine)
    measured["decode_bound_ms"] = bound
    log(f"[moe serve] prefill of {SERVE['batch']} x {SERVE['prompt']} "
        f"tokens: dropped_frac {measured['dropped_frac']:.6f} a layer (the "
        f"sum over {L} layers / {L}; capacity {C} a expert), lb_loss {measured['lb_loss']:.6f} and z_loss "
        f"{measured['z_loss']:.6f} a layer; a decode step reads "
        f"{nbytes} B (every expert at capacity "
        f"{expert_capacity_of(cfg, SERVE['batch'])}, and the cache): byte "
        f"bound {bound:.3f} ms a step, graphed {measured['decode_ms']:.3f} "
        f"ms ({100 * bound / measured['decode_ms']:.1f}% of the bound)")
    prof = phase_profile(
        torch, "MoE decode loop (graph replays)",
        lambda: decode_loop(torch, engine, SERVE["prompt"], SERVE["n_new"]),
        ("norm_kernel", "decode_attention_kernel"))
    report_device_gaps(torch, prof, "MoE decode loop (graph replays)")
    with torch.no_grad():
        phase_profile(torch, "MoE prefill",
                      lambda: engine._prefill(engine.params, batch),
                      ("norm_kernel", "flash_wgmma_kernel"))
    del engine, batch, prof
    free_device_memory(torch)
    wall = time.perf_counter() - t_phase
    log(f"[moe serve] phase wall {wall:.2f} s")
    return launches, shapes, measured, wall


def expert_capacity_of(cfg, n_tokens):
    from repro_torch.models.moe import expert_capacity
    return expert_capacity(n_tokens, cfg.top_k, cfg.n_experts,
                           cfg.capacity_factor)


@contextlib.contextmanager
def recorded_routes(calls, side):
    """Record every `models.moe.route` call's (probs, top_i) on the CPU into
    calls[side[0]], in call order (layer by layer, step by step)."""
    from repro_torch.models import moe
    orig = moe.route

    def route(router, cfg, x):
        out = orig(router, cfg, x)
        calls[side[0]].append((out[1].detach().cpu(), out[3].detach().cpu()))
        return out
    moe.route = route
    try:
        yield
    finally:
        moe.route = orig


def compare_routes(torch, calls, n_layers, what):
    """The card's and the CPU's expert indices, call by call, must be equal.
    Returns the smallest gap between a token's k-th and (k+1)-th router
    probability over all calls (the CPU's). A mismatch names the call's
    layer and step, the token and its gap, so that a float near-tie can be
    told from a bug."""
    if len(calls["cuda"]) != len(calls["cpu"]):
        raise SystemExit(f"chip_smoke: {what}: {len(calls['cuda'])} routing "
                         f"calls on the card, {len(calls['cpu'])} on the CPU")
    least = math.inf
    for i, ((_, ig), (pc, ic)) in enumerate(zip(calls["cuda"],
                                                calls["cpu"])):
        k = ic.shape[1]
        srt = pc.sort(-1, descending=True).values
        gaps = srt[:, k - 1] - srt[:, k]
        least = min(least, float(gaps.min()))
        bad = (ig != ic).any(1).nonzero().flatten().tolist()
        if bad:
            t = bad[0]
            raise SystemExit(
                f"chip_smoke: {what}: expert indices differ at call {i} "
                f"(layer {i % n_layers}, pass {i // n_layers}), {len(bad)} "
                f"tokens, first token {t}: card {ig[t].tolist()} cpu "
                f"{ic[t].tolist()}, its k-th / (k+1)-th gap {float(gaps[t])}"
                f" (least gap of the call {float(gaps.min())})")
    return least


def phase_moe_parity(torch):
    """A 2-layer fp32 cut of qwen3-moe-30b-a3b at full width, the same
    weights on the card and on the CPU: prefill logits and 4 decode steps'
    logits (each step fed the CPU's greedy token on both sides) at atol and
    rtol 1e-3, every layer's expert indices equal at every call; then one
    loss_and_grads (with its dense LiteModel, remat as the config's) at
    1e-3: loss, lb_loss and the metrics, the grad norm, and the gradients
    of layer 0's router, w_up and w_down and of the embedding."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.train import token_batches
    from repro_torch.models.api import (decode_step, init_model,
                                        make_decode_cache, prefill)
    from repro_torch.optim import global_norm
    from repro_torch.train import TrainStepConfig, loss_and_grads
    import numpy as np
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE["arch"]),
                              n_layers=MOE["parity_layers"],
                              dtype=torch.float32)
    lite = cfg.lite()
    B, S, steps = 2, 128, 4
    gen = torch.Generator("cuda").manual_seed(5)
    gpu = {"local": init_model(gen, cfg, "cuda"),
           "lite": init_model(gen, lite, "cuda")}
    sides = {"cuda": gpu,
             "cpu": params_from_numpy(params_to_numpy(gpu), device="cpu")}
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    calls, side = {"cuda": [], "cpu": []}, ["cuda"]
    err, agree = 0.0, 0
    with full_fp32(torch), torch.no_grad(), recorded_routes(calls, side):
        logits, caches = {}, {}
        for dev, params in sides.items():
            side[0] = dev
            logits[dev], pre = prefill(params["local"], cfg, {
                "tokens": torch.as_tensor(tok, device=dev)})
            caches[dev] = make_decode_cache(cfg, B, S + steps, dev)
            for key in ("k", "v"):
                caches[dev]["blocks"][key][:, :, :S] = pre["blocks"][key]
        for i in range(steps + 1):
            a, b = logits["cuda"].cpu(), logits["cpu"]
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
            err = max(err, float((a - b).abs().max()))
            nxt = b[:, -1].argmax(-1)
            agree += int((a[:, -1].argmax(-1) == nxt).sum())
            if i == steps:
                break
            for dev, params in sides.items():
                side[0] = dev
                logits[dev], caches[dev] = decode_step(
                    params["local"], cfg, {"tokens": nxt[:, None].to(dev)},
                    caches[dev], S + i)
    gap = compare_routes(torch, calls, cfg.n_layers, "moe serve parity")
    log(f"[moe parity] serve, {cfg.n_layers}-layer fp32 cut at full width, "
        f"B {B}, S {S}: prefill + {steps} decode steps, max|diff| of logits "
        f"{err:.3e} (atol 1e-3, rtol 1e-3); greedy tokens agree {agree} of "
        f"{B * (steps + 1)}; expert indices equal at all "
        f"{len(calls['cpu'])} routing calls, least k-th / (k+1)-th router "
        f"probability gap {gap:.3e}")
    del caches, logits, pre

    tcfg = TrainStepConfig()
    out = {}
    calls = {"cuda": [], "cpu": []}
    with full_fp32(torch), recorded_routes(calls, side):
        for dev, params in sides.items():
            side[0] = dev
            batch = next(token_batches(cfg, 2, 64, 1, seed=5, device=dev))
            metrics, grads = loss_and_grads(params, cfg, lite, tcfg, batch)
            moe = grads["local"]["blocks"]["moe"]
            picked = [moe["router"][0], moe["w_up"][0], moe["w_down"][0],
                      grads["local"]["io"]["embed"]]
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        float(global_norm(grads)),
                        [t.cpu() for t in picked])
            del grads, moe
        torch.cuda.synchronize()
    gap = compare_routes(torch, calls, cfg.n_layers, "moe train parity")
    (ma, gna, pa), (mb, gnb, pb) = out["cuda"], out["cpu"]
    if set(ma) != set(mb) or "lb_loss" not in mb:
        raise SystemExit(f"chip_smoke: moe train parity metrics {sorted(ma)}"
                         f" / {sorted(mb)}")
    for k in mb:
        if not math.isclose(ma[k], mb[k], rel_tol=1e-3, abs_tol=1e-3):
            raise SystemExit(f"chip_smoke: moe train parity {k}: card "
                             f"{ma[k]} cpu {mb[k]}")
    if not math.isclose(gna, gnb, rel_tol=1e-3, abs_tol=1e-3):
        raise SystemExit(f"chip_smoke: moe grad norm card {gna} cpu {gnb}")
    gerr = _assert_trees_close(torch, pa, pb, 1e-3, "moe train parity grads")
    del sides, gpu, out, pa, pb, params, batch
    free_device_memory(torch)
    wall = time.perf_counter() - t_phase
    log(f"[moe parity] train, same cut (B 2, S 64, remat {cfg.remat}): loss "
        f"card {ma['loss']:.6f} cpu {mb['loss']:.6f}, lb_loss "
        f"{ma['lb_loss']:.6f} / {mb['lb_loss']:.6f}, grad norm {gna:.6f} / "
        f"{gnb:.6f}; grads of layer 0's router, w_up, w_down and the "
        f"embedding max|diff| {gerr:.3e} (atol 1e-3, rtol 1e-3); expert "
        f"indices equal at all {len(calls['cpu'])} routing calls (the "
        f"recomputed forward's included), least gap {gap:.3e}; phase wall "
        f"{wall:.2f} s")
    return wall


# ---------------------------------------------------------------------- #
# 7. the cohort on the card against the cohort on the CPU
# ---------------------------------------------------------------------- #
def phase_parity(torch):
    from repro_torch.fl import FLEnvironment, FLSimConfig, HAPFLServer
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = FLSimConfig(dataset="cifar10", n_train=600, n_test=100,
                      n_clients=6, k_per_round=4, default_epochs=2,
                      batches_per_epoch=1, batch_size=16)
    servers = {dev: HAPFLServer(FLEnvironment(cfg), seed=2, use_ppo1=False,
                                use_ppo2=False, engine="batched",
                                device=dev) for dev in ("cuda", "cpu")}
    gpu, cpu = servers["cuda"], servers["cpu"]
    cpu.lite_params = tree_map(lambda t: t.cpu(), gpu.lite_params)
    cpu.global_by_size = {s: tree_map(lambda t: t.cpu(), p)
                          for s, p in gpu.global_by_size.items()}
    cohort = ([0, 1, 2, 3], ["small", "small", "large", "large"],
              [1, 3, 2, 1])
    with full_fp32(torch):
        out = {dev: srv.batched_engine.train_cohort(
                   *cohort, srv.global_by_size, srv.lite_params)
               for dev, srv in servers.items()}
        torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(out["cuda"], out["cpu"]):
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            torch.testing.assert_close(la.cpu(), lb, atol=1e-4, rtol=1e-3)
            err = max(err, float((la.cpu() - lb).abs().max()))
    log(f"[parity] cuda vs cpu cohort: max|diff| {err:.3e} "
        f"(atol 1e-4, rtol 1e-3)")


# ---------------------------------------------------------------------- #
# 7. where a round's device time goes
# ---------------------------------------------------------------------- #
def phase_profile(torch, label, run, kernels, record_shapes=False,
                  host_ops=True):
    """Run `run()` once under torch.profiler and print the device's busy
    share of its wall time, the top kernels and the port's own `kernels`;
    returns the profile. host_ops=False records the device's events alone
    (no host operator events: a run of a million small kernels, as an
    xLSTM step, otherwise takes minutes to summarise)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if host_ops else [])
    with profile(activities=activities,
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # rows of device-side events only (kernels, copies, memsets): an
    # operator's own row would count its kernels a second time
    rows = [(ev.self_device_time_total, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log(f"[profile] {label} {wall:.3f} s; device time not measured (the "
            "profiler recorded no device events)")
        return prof
    log(f"[profile] {label} {wall:.3f} s wall, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the {label}; idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    for dev_us, count, key in rows[:12]:
        log(f"[profile] {dev_us / 1e3:10.3f} ms {count:7d}x  {key[:90]}")
    # the port's own kernels, wherever they rank: device time per launch
    for dev_us, count, key in rows:
        for kernel in kernels:
            if kernel in key:
                log(f"[profile] {kernel}: {count} launches, "
                    f"{dev_us / 1e3:.3f} ms on the device, "
                    f"{dev_us / count:.2f} us per launch "
                    f"({100 * dev_us / 1e6 / busy:.2f}% of device time)")
    return prof


def decode_loop(torch, engine, start, n):
    """generate's decode loop alone, on the cache the engine's last
    generate left: per step, set the position, replay, keep the token."""
    step = engine.decode_step_for(SERVE["batch"])
    out = torch.empty((SERVE["batch"], n) + step.tokens.shape[2:],
                      dtype=torch.int64, device="cuda")
    for i in range(n):
        step.index.fill_(start + i)
        step.step()
        out[:, i] = step.tokens[:, 0]
    return out


def report_device_gaps(torch, prof, label):
    """The device's timeline in `prof`: the union of its events' intervals
    from the first start to the last end, and the idle gaps between them."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.time_range.end > ev.time_range.start)
    if not spans:
        log(f"[profile] {label}: idle gaps not measured (no device events)")
        return
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(b[0] - a[1] for a, b in zip(merged, merged[1:]))
    span = merged[-1][1] - merged[0][0]
    busy = sum(b - a for a, b in merged)
    big = [g for g in gaps if g > 5]
    log(f"[profile] {label}: device timeline {span / 1e3:.3f} ms from the "
        f"first to the last device event, busy {busy / 1e3:.3f} ms "
        f"({100 * busy / span:.1f}%), {len(gaps)} idle gaps summing "
        f"{sum(gaps) / 1e3:.3f} ms; {len(big)} above 5 us (sum "
        f"{sum(big) / 1e3:.3f} ms, largest {gaps[-1] if gaps else 0:.1f} us, "
        f"median {gaps[len(gaps) // 2] if gaps else 0:.1f} us)")


def check_no_layout_copies(torch, prof, cfg):
    """The prefill must hand the flash kernel its q, k, v as views and take
    its output as one: no aten::clone (what .contiguous() and a reshape
    that cannot be a view call) of a tensor of the attention's shapes,
    (B, H, S, hd), (B, KV, S, hd) or (B, S, H, hd)."""
    B, S = SERVE["batch"], SERVE["prompt"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    layouts = {(B, H, S, hd), (B, KV, S, hd), (B, S, H, hd)}
    clones = [(ev.count, ev.input_shapes)
              for ev in prof.key_averages(group_by_input_shape=True)
              if ev.key == "aten::clone" and ev.input_shapes
              and tuple(ev.input_shapes[0]) in layouts]
    copies = [(ev.count, ev.self_device_time_total, ev.key)
              for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and "copy" in ev.key.lower()]
    log(f"[profile] prefill: layout copies around flash (aten::clone at "
        f"{sorted(layouts)}): {clones or 'none'}; copy kernels in all: "
        f"{sum(c[0] for c in copies)} launches, "
        f"{sum(c[1] for c in copies) / 1e3:.3f} ms of device time")
    if clones:
        raise SystemExit(f"chip_smoke: prefill copies attention tensors "
                         f"around the flash kernel: {clones}")


def check_decode_reads_in_place(torch, engine, B, tag, calls):
    """Two eager runs of the engine's decode step (the function its graph
    captured, on the cache the last generate left) under the profiler: no
    copy operator (aten::clone, copy_, contiguous, _to_copy) of a tensor
    the size of one attention call's K or V cache, and `calls`
    decode_attention launches a step; and the kernel's device time a
    step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as da
    st = engine.decode_step_for(B)
    KV, hd = engine.cfg.n_kv_heads, engine.cfg.resolved_head_dim
    # a call's cache: (B, L, KV, hd), stacked over calls or layers or not
    sizes = {math.prod(t.shape[-4:]) for path, t in _leaf_paths(st.cache)
             if path[-1] in ("k", "v") and tuple(t.shape[-2:]) == (KV, hd)}
    st._run()
    torch.cuda.synchronize()
    before = da.launches["decode_attention"]
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA],
                                  record_shapes=True) as prof:
        for _ in range(2):
            st._run()
        torch.cuda.synchronize()
    ran = (da.launches["decode_attention"] - before) // 2
    copies = [(ev.key, ev.count, ev.input_shapes)
              for ev in prof.key_averages(group_by_input_shape=True)
              if ev.key in ("aten::clone", "aten::copy_", "aten::contiguous",
                            "aten::_to_copy") and ev.input_shapes
              and any(math.prod(sh) in sizes for sh in ev.input_shapes
                      if sh and all(isinstance(x, int) for x in sh))]
    dev = sum(ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and "decode_attention_kernel" in ev.key) / 2e3
    log(f"[{tag}] eager decode step: copies of a cache-sized tensor "
        f"{copies or 'none'}; {ran} decode_attention launches a step "
        f"({calls} attention calls), {dev:.3f} ms of its device time a step")
    if copies or ran != calls:
        raise SystemExit(f"chip_smoke: {tag}: the decode step copies its "
                         f"KV cache ({copies}) or launches decode_attention "
                         f"{ran} times for {calls} attention calls")


# ---------------------------------------------------------------------- #
# 9-12. the training path: llama3.2-3b at full width, the LLM fleet, their
# card-vs-CPU parity, and the backward kernels' times
# ---------------------------------------------------------------------- #
TRAIN_KERNELS = ("rmsnorm", "add_rmsnorm", "rmsnorm_bwd", "add_rmsnorm_bwd",
                 "flash_attention", "flash_attention_bwd", "decode_attention",
                 "kd_loss_grad", "kd_loss_fwd", "kd_loss_bwd")


def train_launch_shapes(cfg, lite):
    """{kernel: {shape: launches}} of one training step on (B, S) tokens.
    Per model of N block norms and A attention calls (`block_norms`), with
    remat every block's forward runs twice (its forward, then again in the
    backward): rmsnorm (the first block's first norm) 2 and its backward 1;
    add_rmsnorm (every other block norm) 2 (N - 1), plus the final norm,
    outside the blocks, once; its backward N; flash 2A and its backward A.
    Without remat the forwards run once. A layernorm config (musicgen,
    xlstm, whose sLSTM blocks remat does not wrap) launches no norm kernel.
    Both models' logits go to one kd_loss_grad launch on (1, B S, V), an
    audio model's on (1, B S nq, V)."""
    B, S = TRAIN["batch"], TRAIN["seq"]
    out = {k: {} for k in TRAIN_KERNELS}

    def add(name, shape, n):
        out[name][shape] = out[name].get(shape, 0) + n

    for c in (cfg, lite):
        (N, A), r = block_norms(c), 2 if c.remat else 1
        dt = str(c.dtype).removeprefix("torch.")
        norm = (B * S, c.d_model, dt)
        flash = (B, c.n_heads, c.n_kv_heads, S, c.resolved_head_dim,
                 c.sliding_window, dt, "bshd")
        if c.norm == "rmsnorm":
            add("rmsnorm", norm, r)
            add("rmsnorm_bwd", norm, 1)
            add("add_rmsnorm", norm, r * (N - 1) + 1)
            add("add_rmsnorm_bwd", norm, N)
        if A:
            add("flash_attention", flash, r * A)
            add("flash_attention_bwd", flash, A)
    add("kd_loss_grad", (1, B * S * (cfg.n_codebooks or 1), cfg.vocab_size,
                         "float32"), 1)
    return out


def phase_train(torch, cfg=None, tag="train"):
    """`cfg` (llama3.2-3b at full width when None) with its LiteModel
    through repro_torch.launch.train's functions: one warm step, then
    TRAIN["steps"] counted and timed steps, their launches exact (the
    optimizer's from the leaves). Returns the state, the step, the batches,
    the counted launches and the expected shapes per step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import token_batches
    from repro_torch.train import (TrainStepConfig, make_hapfl_train_step,
                                   make_train_state)
    from repro_torch.utils.pytree import tree_leaves
    cfg = cfg or get_config(TRAIN["arch"])
    lite = cfg.lite()
    tcfg = TrainStepConfig()
    B, S, n = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = make_train_state(
        torch.Generator("cuda").manual_seed(TRAIN["seed"]), cfg, lite, tcfg,
        "cuda")
    torch.cuda.synchronize()
    params = tree_leaves(state["params"])
    log(f"[{tag}] {cfg.name} (remat {cfg.remat}, {cfg.dtype}) + "
        f"{lite.name} ({lite.n_layers} layers, d {lite.d_model}, "
        f"{lite.n_heads} heads, hd {lite.resolved_head_dim}): "
        f"{sum(t.numel() for t in params)} parameters, "
        f"{sum(t.numel() * t.element_size() for t in params)} B, AdamW "
        f"lr {tcfg.lr}, grad clip {tcfg.grad_clip}; state made in "
        f"{time.perf_counter() - t0:.2f} s")
    step = make_hapfl_train_step(cfg, lite, tcfg)
    batches = list(token_batches(cfg, B, S, 1 + n, TRAIN["seed"],
                                 device="cuda"))
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    log(f"[{tag}] warm step {time.perf_counter() - t0:.3f} s, loss "
        f"{float(m['loss']):.4f}")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    secs, rows = [], []
    for b in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in m.items()})
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    shapes = train_launch_shapes(cfg, lite)
    expected = {k: n * sum(v.values()) for k, v in shapes.items()}
    numels = [t.numel() for t in params]
    expected.update({k: n * c for k, c in optimizer_launches(
        numels, tcfg.grad_clip).items()})
    log(f"[{tag}] launches over {n} steps {launches}, expected {expected}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: {tag} launches {launches} != "
                         f"{expected}")
    for r in rows:
        if not all(math.isfinite(v) for v in r.values()):
            raise SystemExit(f"chip_smoke: non-finite training metrics {r}")
        if cfg.is_moe and "lb_loss" not in r:
            raise SystemExit(f"chip_smoke: {tag}: no lb_loss in {r}")
        log(f"[{tag}] metrics {r}")
    if not _finite(torch, state["params"]):
        raise SystemExit(f"chip_smoke: {tag}: non-finite params after "
                         f"training")
    mean = sum(secs) / n
    PATHS[tag] = {"cfg": cfg, "mode": "train", "launches": dict(launches),
                  "steps": n, "step_s": mean, "leaves": len(numels),
                  "params": sum(numels)}
    log(f"[{tag}] seconds per step after the first {secs} (mean "
        f"{mean:.4f}), {B * S / mean:.1f} tokens/s ({B} x {S} tokens a "
        f"step), max_memory_allocated {peak} B")
    return state, step, batches, launches, shapes


# ---------------------------------------------------------------------- #
# 9b. the training checkpoint
# ---------------------------------------------------------------------- #
def _bits_equal(torch, a, b):
    """Same dtype, shape and bits (bf16 through its 16-bit view)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def phase_train_checkpoint(torch, state, batch):
    """Phase 9's live params saved as launch/train.py --checkpoint saves
    them, restored onto the card with load_checkpoint(like=...): every leaf
    bitwise equal. Then one forward of the local model over the training
    batch on the restored and on the live params: bitwise-equal logits,
    and exactly 1 rmsnorm, 2 L add_rmsnorm and L flash_attention launches
    (no other kernel) for each. Returns the forward's launches."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN["arch"])
    params = state["params"]
    leaves = tree_leaves(params)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[ckpt] {len(leaves)} leaves, {nbytes} B of params; "
            f"{free} B free under {tmp}")
        path = Path(tmp) / "llama"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, params, step=TRAIN["steps"] + 1)
        save_s = time.perf_counter() - t0
        disk = sum(Path(f"{path}{ext}").stat().st_size
                   for ext in (".npz", ".json"))
        t0 = time.perf_counter()
        restored, step = load_checkpoint(path, params, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    log(f"[ckpt] save {save_s:.2f} s ({disk / save_s / 1e9:.3f} GB/s), "
        f"load onto the card {load_s:.2f} s ({disk / load_s / 1e9:.3f} "
        f"GB/s), {disk} B on disk, step {step}")
    got = tree_leaves(restored)
    bad = [i for i, (a, b) in enumerate(zip(got, leaves))
           if a.device != b.device or not _bits_equal(torch, a, b)]
    if step != TRAIN["steps"] + 1 or len(got) != len(leaves) or bad:
        raise SystemExit(f"chip_smoke: the restored checkpoint differs "
                         f"(step {step}, leaves {bad[:8]})")
    log(f"[ckpt] all {len(got)} leaves bitwise equal on the card")
    expected = {k: 0 for k in all_launches()}
    expected.update({"rmsnorm": 1, "add_rmsnorm": 2 * cfg.n_layers,
                     "flash_attention": cfg.n_layers})
    logits = []
    with torch.no_grad():
        for tree in (restored, params):
            reset_all_launches()
            logits.append(api.forward(tree["local"], cfg, batch)[0])
            torch.cuda.synchronize()
            launches = all_launches()
            if launches != expected:
                raise SystemExit(f"chip_smoke: the checkpoint forward "
                                 f"launched {launches} != {expected}")
    if not _bits_equal(torch, *logits):
        raise SystemExit("chip_smoke: logits of the restored params are "
                         "not the live params' bit for bit")
    log(f"[ckpt] forward {tuple(logits[0].shape)} {logits[0].dtype}: "
        f"restored == live bit for bit; launches each {launches}")
    del restored, got, logits
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[ckpt] phase wall {wall:.2f} s")
    return launches, wall


def phase_fleet(torch):
    """Two LLMFleet rounds on the card at the reference's own size (the fp32
    smoke cut): one kd_loss_grad launch per local step, finite globals."""
    from repro_torch.fl.llm_fleet import FleetConfig, LLMFleet
    fleet = LLMFleet(FleetConfig(), device="cuda")
    reset_all_launches()
    steps = 0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = fleet.run_round()
        torch.cuda.synchronize()
        steps += sum(rec["taus"])
        log(f"[fleet] round {rec['round']}: {time.perf_counter() - t0:.3f} "
            f"s, {rec}")
    launches = all_launches()
    log(f"[fleet] launches {launches}")
    if launches["kd_loss_grad"] != steps:
        raise SystemExit(f"chip_smoke: fleet kd_loss_grad launches "
                         f"{launches['kd_loss_grad']} != {steps} local steps")
    # a local step's optimizer: one norm, and as many sumsq as adamw (one
    # a group of leaves)
    if not (launches["sumsq_finish"] == steps
            and launches["sumsq"] == launches["adamw"] >= steps):
        raise SystemExit(f"chip_smoke: fleet optimizer launches {launches} "
                         f"over {steps} local steps")
    if not (_finite(torch, fleet.lite_params) and all(
            _finite(torch, p) for p in fleet.global_by_size.values())):
        raise SystemExit("chip_smoke: non-finite fleet params")


def moe_op_times(torch, prof):
    """{op: device ms} of the MoE operators (MOE_OPS) in `prof`: each op's
    device time with its kernels (none of these ops calls another)."""
    return {ev.key: ev.device_time_total / 1e3
            for ev in prof.key_averages() if ev.key in MOE_OPS}


def phase_moe_train(torch):
    """Phase 9 on qwen3-moe-30b-a3b at full width, cut to MOE["train_layers"]
    of its layers, with its dense LiteModel: the exact launches, finite
    loss, grad norm and lb_loss, seconds a step, tokens/s and peak memory;
    one profiled step with the MoE operators' device time named. Returns
    the launches, the expected shapes a step and the phase's wall
    seconds."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    full = get_config(MOE["arch"])
    cfg = dataclasses.replace(full, n_layers=MOE["train_layers"])
    log(f"[moe train] the one cut: n_layers {full.n_layers} -> "
        f"{cfg.n_layers} ({full.num_params()} -> {cfg.num_params()} "
        f"parameters; AdamW keeps 12 B a parameter); widths as published")
    state, step, batches, launches, shapes = phase_train(torch, cfg,
                                                         "moe train")
    prof = phase_profile(torch, "MoE training step",
                         lambda: step(state, batches[1]),
                         ("flash_bwd_dkdv", "flash_bwd_dq", "norm_bwd_kernel",
                          "norm_kernel", "flash_wgmma_kernel",
                          "kd_grad_row_kernel", "indexFunc", "indexSelect"))
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    ops = moe_op_times(torch, prof)
    total = sum(ops.values())
    log(f"[moe train] the MoE operators' device time in the profiled step: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(ops.items()))
        + f"; {total:.3f} ms together, "
        f"{100 * total / busy if busy else 0:.1f}% of {busy:.3f} ms busy "
        f"(aten::bmm: the expert products, forward, remat's recompute and "
        f"backward; index_add / index_select: the dispatch scatter and the "
        f"combine gather and their backwards)")
    del state, step, batches, prof
    free_device_memory(torch)
    wall = time.perf_counter() - t_phase
    log(f"[moe train] phase wall {wall:.2f} s")
    return launches, shapes, wall


# ---------------------------------------------------------------------- #
# 5e-5g, 9d and 9e. the VLM and audio families: qwen2-vl-2b and
# musicgen-medium served and trained at full width and depth, and 2-layer
# fp32 cuts of each on the card against the CPU
# ---------------------------------------------------------------------- #
def phase_family_serve(torch, arch, cfg=None):
    """Phase 5's serve path on `arch` at full width and depth (or on `cfg`),
    after the free device memory is logged: the exact launches, graphed ==
    eager bit for bit, the times, peak memory and the decode step's byte
    bound (the KV cache at max_len and the recurrent state included). An
    xLSTM's prefill is run once more with its sLSTM blocks timed
    (`slstm_share`). Returns the launches, the expected shapes, the times
    and the phase's wall seconds; a profiled graphed decode loop shows
    where a step's device time goes."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = cfg or get_config(arch)
    tag = f"{cfg.family} serve"
    free_device_memory(torch)
    free, total = torch.cuda.mem_get_info()
    log(f"[{tag}] free device memory before init {free} B of {total} B; "
        f"allocated {torch.cuda.memory_allocated()} B")
    engine, batch, launches, shapes, measured = phase_serve(torch, cfg, tag)
    nbytes, bound, cache = decode_bound_ms(torch, engine)
    measured["decode_bound_ms"] = bound
    log(f"[{tag}] a decode step moves {nbytes} B (the weights, of an "
        f"untied embedding the rows it gathers, the {cache} B cache at "
        f"max_len {SERVE['max_len']}: KV read, recurrent state read and "
        f"written): byte bound {bound:.3f} ms a step; graphed "
        f"{measured['decode_ms']:.3f} ms ({100 * bound / measured['decode_ms']:.1f}% "
        f"of the bound), replay device time {measured['replay_ms']:.3f} ms")
    if cfg.block_kind == "xlstm":
        measured["slstm"] = slstm_share(torch, engine, batch, tag)
    label = f"{cfg.name} decode loop (graph replays)"
    prof = phase_profile(
        torch, label,
        lambda: decode_loop(torch, engine, SERVE["prompt"], SERVE["n_new"]),
        ("norm_kernel",))
    report_device_gaps(torch, prof, label)
    del engine, batch, prof
    free_device_memory(torch)
    wall = time.perf_counter() - t_phase
    log(f"[{tag}] phase wall {wall:.2f} s")
    return launches, shapes, measured, wall


def zamba2_launch_shapes(cfg, B, S, n, max_len):
    """{kernel: {shape: launches}} of one generate of family "zamba2" (B
    prompts of S tokens, n new, a decode cache of max_len slots): each
    forward norms every Mamba2 layer's input, the first with rmsnorm
    unless a shared-block call joins it, the
    others with add_rmsnorm (the residual add before it, a call's output
    joined in); each call runs rmsnorm on its 2 d-wide input and on its
    attention's output, and the final norm is an add_rmsnorm, on the last
    position only in the prefill. The prefill runs flash attention once a
    call at hd 224, each decode step the decode attention once a call."""
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dt = str(cfg.dtype).removeprefix("torch.")
    C = len(cfg.hybrid_layer_ids)
    first = int(0 not in cfg.hybrid_layer_ids)
    rms, add = C + first, cfg.n_layers - first
    shapes = {k: {} for k in serve_launch_shapes(cfg)}
    shapes["rmsnorm"] = {(B * S, d, dt): rms, (B * S, 2 * d, dt): C,
                         (B, d, dt): rms * n, (B, 2 * d, dt): C * n}
    shapes["add_rmsnorm"] = {(B * S, d, dt): add, (B, d, dt): 1 + (add + 1) * n}
    shapes["flash_attention"] = {(B, H, KV, S, cfg.resolved_head_dim, 0, dt,
                                  "bshd"): C}
    shapes["decode_attention"] = {decode_shape(cfg, B, max_len): C * n}
    return shapes


def check_zamba2_kernels(torch, cfg, shapes):
    """The norms at every shape of the generate and flash at its prefill's
    shape, with the config's scale (hd / 2)^-0.5, against their plain
    versions (TOL_NORM, TOL_FLASH), and flash's times there: the kernel,
    the plain version and SDPA at the same scale, against its bound.
    Returns ({key: max|err|}, {flash key: times})."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn
    scale = (cfg.resolved_head_dim / 2) ** -0.5
    errs, times = {}, {}
    with full_fp32(torch):
        for N, d, dtype in shapes["rmsnorm"]:
            x, sc = _norm_inputs(torch, N, d, dtype)
            got, exp = (rn.rmsnorm(x, sc),), (ref.rmsnorm_ref(x, sc),)
            _close(torch, got, exp, TOL_NORM[dtype], f"rmsnorm {N}x{d}")
            errs[("rmsnorm", N, d, dtype)] = _max_err(torch, got, exp)
        for N, d, dtype in shapes["add_rmsnorm"]:
            x, delta, sc = _add_norm_inputs(torch, N, d, dtype)
            got = rn.add_rmsnorm(x, delta, sc)
            exp = ref.add_rmsnorm_ref(x, delta, sc)
            _close(torch, got, exp, TOL_NORM[dtype], f"add_rmsnorm {N}x{d}")
            errs[("add_rmsnorm", N, d, dtype)] = _max_err(torch, got, exp)
        for key in shapes["flash_attention"]:
            B, H, KV, S, hd, window, dtype, layout = key
            q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
            got = (fa.flash_attention(q, k, v, causal=True, scale=scale),)
            torch.cuda.synchronize()
            exp = (ref.flash_attention_ref(q, k, v, causal=True,
                                           scale=scale),)
            what = (f"flash_attention B{B} H{H} KV{KV} S{S} hd{hd} scale "
                    f"{scale:.6f} {dtype} {layout}")
            _close(torch, got, exp, TOL_FLASH[dtype], what)
            errs[("flash_attention", *key)] = e = _max_err(torch, got, exp)
            log(f"[zamba2 serve] {what}: max|err| {e:.3e} (tol "
                f"{TOL_FLASH[dtype]})")
            del got, exp
            nxt = _cold_copies((q, k, v), (2 * q.numel() + k.numel()
                                           + v.numel()) * q.element_size())
            fns = {"kernel": lambda: fa.flash_attention(
                       *nxt(), causal=True, scale=scale),
                   "plain": lambda: ref.flash_attention_ref(
                       *nxt(), causal=True, scale=scale),
                   "library": lambda: F.scaled_dot_product_attention(
                       *nxt(), is_causal=True, scale=scale,
                       enable_gqa=True),
                   "kernel_warm": lambda: fa.flash_attention(
                       q, k, v, causal=True, scale=scale)}
            times[("flash_attention", *key)] = _time_set(
                torch, "flash_attention", key, fns,
                _cost().flash_bound(B, H, KV, S, hd, window, dtype,
                                    q.element_size()), 10)
    log("[zamba2 serve] the norms against their plain versions: " + ", ".join(
        f"{k[0]} {k[1]}x{k[2]} {e:.3e}" for k, e in errs.items()
        if k[0] != "flash_attention"))
    return errs, times


def phase_zamba2_serve(torch):
    """Phase 9h: Zamba2-7B-Instruct as published (81 Mamba2 layers, two
    shared blocks over 13 calls at hd 224, 7.36 B parameters) whole on the
    card at ZAMBA2's shapes, through `ServeEngine.generate` with the
    prompt's state carried: its kernels at their shapes (`check_zamba2_
    kernels`); the exact launches of a generate (13 flash a call); graphed
    == eager bit for bit; the times, peak memory and the decode step's
    byte bound; a profiled generate, whose flash launches must be the
    port's flash_wgmma_kernel, once a call. Returns (launches, shapes,
    errs, times, measured)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import init_model
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_config(ZAMBA2["arch"])
    tag = "zamba2 serve"
    B, S, n = ZAMBA2["batch"], ZAMBA2["prompt"], ZAMBA2["n_new"]
    if not cfg.carry_prompt_state:
        raise SystemExit(f"chip_smoke: {cfg.name} does not carry the "
                         f"prompt's state into the decode")
    shapes = zamba2_launch_shapes(cfg, B, S, n, ZAMBA2["max_len"])
    free_device_memory(torch)
    errs, times = check_zamba2_kernels(torch, cfg, shapes)
    free_device_memory(torch)
    params = init_model(torch.Generator("cuda").manual_seed(ZAMBA2["seed"]),
                        cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} Mamba2 layers (groups "
        f"{cfg.mamba_groups}, dt_min {cfg.dt_min}), {cfg.shared_blocks} "
        f"shared blocks over calls at {list(cfg.hybrid_layer_ids)}, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
        f"adapter rank {cfg.shared_mlp_adapter_rank}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {n_params} parameters "
        f"(num_params() {cfg.num_params()}), "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params))} B")
    batch = serve_batch(torch, cfg, B, S, ZAMBA2["seed"])
    engine = ServeEngine(cfg, params, max_len=ZAMBA2["max_len"],
                         device="cuda")
    engine.generate(batch, n_new=2)   # captures the decode step; warm-up
    step = engine.decode_step_for(B)
    if step.graph is None:
        raise SystemExit(f"chip_smoke: {tag}: the decode step is not a CUDA "
                         f"graph")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = engine.generate(batch, n_new=n)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: sum(v.values()) for k, v in shapes.items()}
    log(f"[{tag}] launches {launches}, expected {expected}")
    if launches != expected:
        raise SystemExit(f"chip_smoke: {tag} launches {launches} != "
                         f"{expected}")
    if (out.shape != (B, n) or out.min() < 0
            or out.max() >= cfg.vocab_size):
        raise SystemExit(f"chip_smoke: {tag}: generate gave {out.shape} "
                         f"tokens in [{out.min()}, {out.max()}]")
    check_graph_is_eager(torch, engine, batch, n, f"{cfg.name} whole", tag)
    check_decode_reads_in_place(torch, engine, B, tag,
                                len(cfg.hybrid_layer_ids))
    runs = {}
    for k in (1, n, n, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(batch, n_new=k)
        torch.cuda.synchronize()
        runs.setdefault(k, []).append(time.perf_counter() - t0)
    t1, tn = (sum(runs[k]) / 2 for k in (1, n))
    decode_ms = (tn - t1) / (n - 1) * 1e3
    prefill_ms = t1 * 1e3 - decode_ms
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        step.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / n
    nbytes, bound, cache = decode_bound_ms(torch, engine, B)
    log(f"[{tag}] generate(1) {runs[1]} s, generate({n}) {runs[n]} s -> "
        f"prefill {prefill_ms:.3f} ms ({B * S / prefill_ms * 1e3:.0f} prompt "
        f"tokens/s), decode {decode_ms:.3f} ms a step of {B} tokens graphed "
        f"(replay device time {replay_ms:.3f} ms); {B * n / tn:.1f} "
        f"generated tokens/s over generate({n}); a decode step moves "
        f"{nbytes} B (the {cache} B cache at max_len {ZAMBA2['max_len']}): "
        f"byte bound {bound:.3f} ms, {100 * bound / replay_ms:.1f}% of the "
        f"replay; max_memory_allocated {peak} B")
    prof = phase_profile(torch, f"{cfg.name} generate({n})",
                         lambda: engine.generate(batch, n_new=n),
                         ("norm_kernel", "flash_wgmma_kernel",
                          "decode_attention_kernel"))
    ran = {k: sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and k in ev.key)
           for k in ("flash_wgmma_kernel", "decode_attention_kernel")}
    flash = ran["flash_wgmma_kernel"]
    C = len(cfg.hybrid_layer_ids)
    if ran != {"flash_wgmma_kernel": C, "decode_attention_kernel": C * n}:
        raise SystemExit(f"chip_smoke: {tag}: the profiled generate ran "
                         f"{ran}, not flash once a shared-block call ({C}) "
                         f"and the decode attention once a call a step "
                         f"({C * n})")
    report_device_gaps(torch, prof, f"{cfg.name} generate({n})")
    del engine, batch, params, prof, step, out
    free_device_memory(torch)
    measured = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                "replay_ms": replay_ms, "decode_bound_ms": bound,
                "tokens_per_s": B * n / tn, "peak_bytes": peak,
                "flash_profiled": flash,
                "wall_s": time.perf_counter() - t_phase}
    log(f"[{tag}] phase wall {measured['wall_s']:.2f} s")
    return launches, shapes, errs, times, measured


def phase_family_parity(torch, arch, cfg=None):
    """A 2-layer fp32 cut of `arch` at full width (or `cfg`, fp32), the same
    weights on the card and on the CPU: prefill logits and 4 decode steps'
    logits (each step fed the CPU's greedy tokens on both sides; a VLM
    feeds their embedding rows; the prefill's cache carried into the decode
    cache whole: KV at the origin, recurrent states as they are) at atol
    and rtol 1e-3, and an SSM's or hybrid's every cache leaf after the last
    step; then one loss_and_grads with its LiteModel (remat as the
    config's): loss, metrics and grad norm, and the gradients of layer 0's
    wq, the norm params (layernorm: scale and bias) and the embedding
    tables (an SSM's or hybrid's: every gradient of both models) at 1e-3.
    A VLM never reads its token embedding in training: its gradient must
    be exactly zero on both sides. Returns the phase's wall seconds."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.train import token_batches
    from repro_torch.models.api import (decode_step, init_model,
                                        make_decode_cache, prefill)
    from repro_torch.optim import global_norm
    from repro_torch.serve import decode_batch
    from repro_torch.train import TrainStepConfig, loss_and_grads
    from repro_torch.utils.pytree import tree_leaves
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(
        cfg or dataclasses.replace(get_config(arch),
                                   n_layers=VLM_AUDIO["parity_layers"]),
        dtype=torch.float32)
    lite = cfg.lite()
    ssm_like = cfg.block_kind != "attention"
    tag = f"{cfg.family} parity"
    B, S, steps = 2, 128, 4
    gen = torch.Generator("cuda").manual_seed(6)
    gpu = {"local": init_model(gen, cfg, "cuda"),
           "lite": init_model(gen, lite, "cuda")}
    sides = {"cuda": gpu,
             "cpu": params_from_numpy(params_to_numpy(gpu), device="cpu")}
    prompt = {k: v.cpu() for k, v in serve_batch(torch, cfg, B, S, 6).items()}
    err, agree = 0.0, 0
    with full_fp32(torch), torch.no_grad():
        logits, caches = {}, {}
        for dev, params in sides.items():
            logits[dev], pre = prefill(params["local"], cfg, {
                k: v.to(dev) for k, v in prompt.items()})
            caches[dev] = make_decode_cache(cfg, B, S + steps, dev)
            carried = dict(_leaf_paths(pre))
            for path, big in _leaf_paths(caches[dev]):
                small = carried[path]
                big[tuple(slice(0, n) for n in small.shape)] = small
        for i in range(steps + 1):
            a, b = logits["cuda"].cpu(), logits["cpu"]
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
            err = max(err, float((a - b).abs().max()))
            nxt = b[:, -1].argmax(-1)
            agree += int((a[:, -1].argmax(-1) == nxt).sum())
            if i == steps:
                break
            for dev, params in sides.items():
                logits[dev], caches[dev] = decode_step(
                    params["local"], cfg,
                    decode_batch(cfg, params["local"], nxt[:, None].to(dev)),
                    caches[dev], S + i)
    cerr = (_assert_trees_close(torch, caches["cuda"], caches["cpu"], 1e-3,
                                f"{tag} decode cache") if ssm_like else None)
    log(f"[{tag}] serve, {cfg.n_layers}-layer fp32 cut of {arch} "
        f"({cfg.name}, d {cfg.d_model}), B {B}, S {S}: prefill + {steps} "
        f"decode steps, max|diff| of logits {err:.3e} (atol 1e-3, rtol "
        f"1e-3)" + (f", of every cache leaf after the last step {cerr:.3e}"
                    if ssm_like else "")
        + f"; greedy tokens agree {agree} of {nxt.numel() * (steps + 1)}")
    del caches, logits, pre

    tcfg = TrainStepConfig()
    batch = next(token_batches(cfg, 2, 64, 1, seed=6, device="cpu"))
    out = {}
    with full_fp32(torch):
        for dev, params in sides.items():
            metrics, grads = loss_and_grads(
                params, cfg, lite, tcfg,
                {k: v.to(dev) for k, v in batch.items()})
            io = grads["local"]["io"]
            if ssm_like:
                picked = tree_leaves(grads)
            else:
                blocks = grads["local"]["blocks"]
                picked = [blocks["attn"]["wq"][0],
                          *[t[0] for k in ("norm1", "norm2")
                            for t in blocks[k].values()],
                          *io["norm_f"].values(), io["embed"]]
            zero_embed = [bool((grads[m]["io"]["embed"] == 0).all())
                          for m in ("local", "lite")]
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        float(global_norm(grads)),
                        [t.cpu() for t in picked], zero_embed)
            del grads, io
        torch.cuda.synchronize()
    (ma, gna, pa, za), (mb, gnb, pb, zb) = out["cuda"], out["cpu"]
    for k in mb:
        if not math.isclose(ma[k], mb[k], rel_tol=1e-3, abs_tol=1e-3):
            raise SystemExit(f"chip_smoke: {tag} {k}: card {ma[k]} cpu "
                             f"{mb[k]}")
    if not math.isclose(gna, gnb, rel_tol=1e-3, abs_tol=1e-3):
        raise SystemExit(f"chip_smoke: {tag} grad norm card {gna} cpu {gnb}")
    if cfg.input_mode == "embeddings" and not (all(za) and all(zb)):
        raise SystemExit(f"chip_smoke: {tag}: the token embedding's "
                         f"gradient is not exactly zero (card {za}, cpu "
                         f"{zb})")
    gerr = _assert_trees_close(torch, pa, pb, 1e-3, f"{tag} grads")
    n_picked = len(pa)
    del sides, gpu, out, pa, pb, params
    free_device_memory(torch)
    wall = time.perf_counter() - t_phase
    log(f"[{tag}] train, same cut (B 2, S 64, remat {cfg.remat}): loss card "
        f"{ma['loss']:.6f} cpu {mb['loss']:.6f}, grad norm {gna:.6f} / "
        f"{gnb:.6f}; "
        + (f"all {n_picked} gradients of both models" if ssm_like else
           "grads of layer 0's wq, the norm params and the embedding")
        + f" max|diff| {gerr:.3e} (atol 1e-3, rtol 1e-3)"
        + ("; the token embedding's gradient exactly zero on both sides "
           "(local and lite)" if cfg.input_mode == "embeddings" else "")
        + f"; phase wall {wall:.2f} s")
    return wall


def slstm_share(torch, engine, batch, tag):
    """The sLSTM blocks' share of an xLSTM prefill: one prefill timed whole,
    then one with each sLSTM block's call timed, the card synchronised
    around it (their sum over that prefill's seconds). Returns the
    seconds and the share."""
    from repro_torch.models import transformer
    apply = transformer._SSM_APPLIES["slstm"]
    secs = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(*a, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    walls = []
    with torch.no_grad():
        for wrap in (False, True):
            transformer._SSM_APPLIES["slstm"] = timed if wrap else apply
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine._prefill(engine.params, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            finally:
                transformer._SSM_APPLIES["slstm"] = apply
    out = {"prefill_s": walls[0], "timed_prefill_s": walls[1],
           "slstm_s": sum(secs), "share": sum(secs) / walls[1]}
    log(f"[{tag}] prefill {walls[0]:.4f} s; with each sLSTM block timed "
        f"{walls[1]:.4f} s, of which the {len(secs)} sLSTM blocks (a "
        f"Python loop of {SERVE['prompt']} steps each) "
        f"{out['slstm_s']:.4f} s: {100 * out['share']:.1f}% of the prefill "
        f"({', '.join(f'{t:.4f}' for t in secs)} s)")
    return out


def slstm_step_share(torch, state, cfg, batch, step, tag):
    """The sLSTM blocks' share of an xLSTM training step: one more step
    timed whole, then each of the local model's sLSTM blocks (its own
    trained params) run forward and backward alone at the step's shapes,
    (B, S, d) N(0, 1) in cfg.dtype, the card synchronised around each
    half. No checkpoint wraps the sLSTM, so the step runs its forward
    once and its backward once. Returns the seconds and the share."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import _unstack
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    B, S = TRAIN["batch"], TRAIN["seq"]
    x = torch.randn((B, S, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7)
                    ).to(cfg.dtype)
    fwd, bwd = [], []
    for p in _unstack(state["params"]["local"]["slstm"]):
        core = {k: v.detach().requires_grad_(True)
                for k, v in p["core"].items()}
        xi = x.detach().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = ssm.apply_slstm(core, cfg, xi)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(y, [xi, *core.values()], torch.ones_like(y))
        torch.cuda.synchronize()
        fwd.append(t1 - t0)
        bwd.append(time.perf_counter() - t1)
    total = sum(fwd) + sum(bwd)
    log(f"[{tag}] one more step {step_s:.4f} s; its {len(fwd)} sLSTM blocks "
        f"alone at ({B}, {S}, {cfg.d_model}): forward {sum(fwd):.4f} s, "
        f"backward {sum(bwd):.4f} s, together {total:.4f} s = "
        f"{100 * total / step_s:.1f}% of the step")
    return {"step_s": step_s, "forward_s": sum(fwd), "backward_s": sum(bwd),
            "share": total / step_s}


def phase_family_train(torch, arch, cfg=None):
    """Phase 9 on `arch` at full width and depth (or on `cfg`) with its
    LiteModel, after the free device memory is logged: exact launches,
    finite loss and grad norm, seconds a step, tokens/s (token positions,
    B S a step: an audio model's nq codebook entries a position count
    once), peak memory; one profiled step; an xLSTM's sLSTM blocks timed
    forward and backward at the step's shapes (`slstm_step_share`).
    Returns the launches, the expected shapes a step and the phase's wall
    seconds."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = cfg or get_config(arch)
    tag = f"{cfg.family} train"
    free_device_memory(torch)
    free, total = torch.cuda.mem_get_info()
    log(f"[{tag}] free device memory before init {free} B of {total} B; "
        f"allocated {torch.cuda.memory_allocated()} B")
    state, step, batches, launches, shapes = phase_train(torch, cfg, tag)
    if cfg.block_kind == "xlstm":
        slstm_step_share(torch, state, cfg, batches[1], step, tag)
    phase_profile(torch, f"{cfg.name} training step",
                  lambda: step(state, batches[1]),
                  ("flash_bwd_dkdv", "flash_bwd_dq", "norm_bwd_kernel",
                   "norm_kernel", "flash_wgmma_kernel", "kd_grad_warp_kernel",
                   "kd_grad_row_kernel"),
                  host_ops=cfg.block_kind != "xlstm")
    del state, step, batches
    free_device_memory(torch)
    wall = time.perf_counter() - t_phase
    log(f"[{tag}] phase wall {wall:.2f} s")
    return launches, shapes, wall


def _assert_trees_close(torch, got, exp, tol, what, held=None):
    """Leaf by leaf at atol = rtol = tol; with `held` (a tree of bool masks
    like `exp`) only the elements it marks."""
    from repro_torch.utils.pytree import tree_leaves
    err = 0.0
    masks = tree_leaves(held) if held is not None else [None] * len(
        tree_leaves(exp))
    for a, b, mask in zip(tree_leaves(got), tree_leaves(exp), masks):
        a, b = a.detach().cpu().float(), b.detach().cpu().float()
        if mask is not None:
            a, b = a[mask], b[mask]
        if a.numel():
            err = max(err, float((a - b).abs().max()))
        torch.testing.assert_close(a, b, atol=tol, rtol=tol,
                                   msg=lambda m: f"{what}: {m}")
    return err


def phase_train_parity(torch):
    """One train step of a 2-layer fp32 cut of the full-width llama (and
    its LiteModel, remat as the config's), the same weights and tokens on
    the card and on the CPU: loss, metrics and grad norm, and the gradients
    of wq, the norm scales and the embedding (both models), at atol and
    rtol 1e-3."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.train import token_batches
    from repro_torch.optim import adamw, global_norm
    from repro_torch.train import (TrainStepConfig, loss_and_grads,
                                   make_hapfl_train_step, make_train_state)
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=2,
                              dtype=torch.float32)
    lite = cfg.lite()
    tcfg = TrainStepConfig()
    gpu = make_train_state(torch.Generator("cuda").manual_seed(4), cfg, lite,
                           tcfg, "cuda")
    cpu_params = params_from_numpy(params_to_numpy(gpu["params"]), "cpu")
    states = {"cuda": gpu, "cpu": {"params": cpu_params,
                                   "opt": adamw(tcfg.lr).init(cpu_params)}}
    out = {}
    with full_fp32(torch):
        for dev, state in states.items():
            batch = next(token_batches(cfg, 2, 64, 1, seed=4, device=dev))
            metrics, grads = loss_and_grads(state["params"], cfg, lite, tcfg,
                                            batch)
            picked = [grads[m]["blocks"]["attn"]["wq"] for m in ("local",
                                                                 "lite")]
            picked += [grads[m]["blocks"][k]["scale"]
                       for m in ("local", "lite") for k in ("norm1", "norm2")]
            picked += [grads[m]["io"][k] if k == "embed" else
                       grads[m]["io"][k]["scale"]
                       for m in ("local", "lite") for k in ("embed", "norm_f")]
            gn = global_norm(grads)
            del grads
            _, m2 = make_hapfl_train_step(cfg, lite, tcfg)(state, batch)
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        float(gn), [t.cpu() for t in picked],
                        {k: float(v) for k, v in m2.items()})
        torch.cuda.synchronize()
    (ma, gna, pa, sa), (mb, gnb, pb, sb) = out["cuda"], out["cpu"]
    for k in mb:
        if not math.isclose(ma[k], mb[k], rel_tol=1e-3, abs_tol=1e-3):
            raise SystemExit(f"chip_smoke: train parity {k}: card {ma[k]} "
                             f"cpu {mb[k]}")
    for k in ("loss", "grad_norm"):
        if not math.isclose(sa[k], sb[k], rel_tol=1e-3, abs_tol=1e-3):
            raise SystemExit(f"chip_smoke: train step parity {k}: card "
                             f"{sa[k]} cpu {sb[k]}")
    if not math.isclose(gna, gnb, rel_tol=1e-3, abs_tol=1e-3):
        raise SystemExit(f"chip_smoke: grad norm card {gna} cpu {gnb}")
    err = _assert_trees_close(torch, pa, pb, 1e-3, "train parity grads")
    log(f"[parity] train, 2-layer fp32 cut at full width (B 2, S 64): loss "
        f"card {ma['loss']:.6f} cpu {mb['loss']:.6f}, grad norm "
        f"{gna:.6f} / {gnb:.6f}, the step's {sa['loss']:.6f} / "
        f"{sb['loss']:.6f}; grads of wq, the norm scales and the embedding "
        f"(both models) max|diff| {err:.3e} (atol 1e-3, rtol 1e-3)")


def phase_fleet_parity(torch):
    """One LLMFleet round on the card and on the CPU from the same globals,
    with the sizes and intensities injected: clients, sizes, taus and
    straggling equal, and the aggregated lite and size globals at 1e-3
    wherever the CPU's gradient was at least 1e-5 in size at every local
    step that fed them: Adam's first step moves a parameter by about lr
    times the sign of its gradient, so float noise in a near-zero gradient
    becomes a move of +-lr. At least 70% of each aggregate is held."""
    from repro_torch.fl.llm_fleet import FleetConfig, LLMFleet
    from repro_torch.train import loss_and_grads
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = dict(n_clients=4, k_per_round=2, seq=32, batch=2, default_steps=2)
    fleets = {dev: LLMFleet(FleetConfig(**cfg), device=dev)
              for dev in ("cuda", "cpu")}
    gpu, cpu = fleets["cuda"], fleets["cpu"]
    cpu.lite_params = tree_map(lambda t: t.cpu(), gpu.lite_params)
    cpu.global_by_size = {s: tree_map(lambda t: t.cpu(), p)
                          for s, p in gpu.global_by_size.items()}
    sizes, taus = ["small", "large"], [2, 1]
    g_min = {}    # the least |g| of each element over the CPU's local steps

    def recorded(s, step):
        def run(state, batch):
            _, g = loss_and_grads(state["params"], cpu.pool[s], cpu.lite,
                                  cpu.tcfg, batch)
            for name, tree in (("lite", g["lite"]), (s, g["local"])):
                size = tree_map(torch.abs, tree)
                g_min[name] = size if name not in g_min else tree_map(
                    torch.minimum, g_min[name], size)
            return step(state, batch)
        return run

    cpu._steps = {s: recorded(s, f) for s, f in cpu._steps.items()}
    recs = {}
    with full_fp32(torch):
        for dev, f in fleets.items():
            f.allocator.allocate = lambda gen, assess: (sizes, None)
            f.intensity.assign = lambda gen, modified: (taus, None)
            f.allocator.feedback = f.intensity.feedback = lambda *a: 0.0
            recs[dev] = f.run_round()
        torch.cuda.synchronize()
    for k in ("clients", "sizes", "taus", "straggling"):
        if recs["cuda"][k] != recs["cpu"][k]:
            raise SystemExit(f"chip_smoke: fleet parity {k}: "
                             f"{recs['cuda'][k]} != {recs['cpu'][k]}")
    trees = {"lite": (gpu.lite_params, cpu.lite_params)}
    trees.update({s: (gpu.global_by_size[s], cpu.global_by_size[s])
                  for s in set(sizes)})
    err, shares = 0.0, []
    for name, (got, exp) in trees.items():
        held = tree_map(lambda g: g >= 1e-5, g_min[name])
        n_held = sum(int(m.sum()) for m in tree_leaves(held))
        n_all = sum(m.numel() for m in tree_leaves(held))
        shares.append(f"{name} {n_held / n_all:.3f}")
        if n_held < 0.7 * n_all:
            raise SystemExit(f"chip_smoke: fleet parity {name}: only "
                             f"{n_held} of {n_all} elements held")
        err = max(err, _assert_trees_close(torch, got, exp, 1e-3,
                                           f"fleet parity {name}", held))
    log(f"[parity] fleet round, sizes {sizes} and taus {taus} injected: "
        f"clients, sizes, taus and straggling equal; accuracies card "
        f"{recs['cuda']['acc_local_mean']:.4f} / "
        f"{recs['cuda']['acc_lite_mean']:.4f}, cpu "
        f"{recs['cpu']['acc_local_mean']:.4f} / "
        f"{recs['cpu']['acc_lite_mean']:.4f}; aggregated params max|diff| "
        f"{err:.3e} (atol and rtol 1e-3 where every CPU step's |g| >= 1e-5;"
        f" held shares {', '.join(shares)})")


def _backward_ms(torch, fwd, nxt, iters):
    """Device ms of a PyTorch function's backward alone: graph replays of
    its forward and backward together, less those of its forward alone.
    nxt() gives (inputs, upstream gradients)."""
    def both():
        ins, grads = nxt()
        ins = [t.detach().requires_grad_(True) for t in ins]
        torch.autograd.grad(fwd(*ins), ins, grads)

    def forward():
        ins, _ = nxt()
        fwd(*[t.detach().requires_grad_(True) for t in ins])
    return _graph_ms(torch, both, iters) - _graph_ms(torch, forward, iters)


def kernel_split(torch, label, call, iters):
    """Device ms per launch of each kernel that `call()` launches (each
    launches once a call): `iters` eager calls under torch.profiler, each
    kernel's device time summed by name and divided by the launches the
    profiler recorded; beside it the whole call's device ms from CUDA events
    around a graph of `iters` calls. Returns {kernel: ms}."""
    from torch.profiler import ProfilerActivity, profile
    total = _graph_ms(torch, call, iters)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    split = {ev.key: ev.self_device_time_total / 1e3 / ev.count
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and ev.self_device_time_total > 0}
    log(f"[timing] {label}: {total:.6f} ms a call (CUDA events over a graph "
        f"of {iters}); by kernel (profiler, eager calls): "
        + ("; ".join(f"{k[:60]} {v:.6f} ms" for k, v in split.items())
           or "not measured (the profiler recorded no device events)"))
    return split


def phase_norm_bwd_split(torch, shapes):
    """kernel_split of rmsnorm_bwd and add_rmsnorm_bwd at each (N, d,
    dtype), their inputs cycled L2-cold as in _time_set: the backward must
    be one kernel."""
    from repro_torch.kernels import rmsnorm as rn
    out = {}
    for N, d, dtype in shapes:
        x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
        g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
        gs = _randn(torch, (N, d), dtype, g)
        nxt = _cold_copies((x, sc, gs, dy), 4 * x.numel() * x.element_size())
        def plain_bwd():
            a, b, _, c = nxt()
            return rn.rmsnorm_bwd(a, b, c)
        for name, call in (("rmsnorm_bwd", plain_bwd),
                           ("add_rmsnorm_bwd",
                            lambda: rn.add_rmsnorm_bwd(*nxt()))):
            split = kernel_split(torch, f"{name} {(N, d, dtype)}", call, 50)
            if split and len(split) != 1:
                raise SystemExit(f"chip_smoke: {name} {(N, d, dtype)} "
                                 f"launched {sorted(split)}, not one kernel")
            out[(name, N, d, dtype)] = split
    return out


def phase_train_timing(torch, shapes):
    """Times of the backward kernels, their plain versions and, where one
    PyTorch call computes the same function, that call's backward alone
    (F.rms_norm's; F.scaled_dot_product_attention's with enable_gqa), at
    the training path's shapes; and of the flash forward with and without
    its lse output."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rn

    def rms(x, scale):
        return F.rms_norm(x, (x.shape[-1],), scale, 1e-5)

    def add_rms(x, delta, scale):
        s = x + delta
        return s, rms(s, scale)

    times = {}
    for N, d, dtype in shapes["rmsnorm_bwd"]:
        x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
        nbytes = 3 * x.numel() * x.element_size()
        nxt = _cold_copies((x, sc, dy), nbytes)
        fns = {"kernel": lambda: rn.rmsnorm_bwd(*nxt()),
               "plain": lambda: ref.rmsnorm_bwd_ref(*nxt()),
               "library": None,
               "kernel_warm": lambda: rn.rmsnorm_bwd(x, sc, dy)}
        t = _time_set(torch, "rmsnorm_bwd", (N, d, dtype), fns,
                      _cost().norm_bwd_bound(N, d, x.element_size(),
                                             False), 50)
        lib_nxt = _cold_copies((x, sc, dy), nbytes)

        def rms_inputs():
            a, b, c = lib_nxt()
            return (a, b), c
        t["library_ms"] = _backward_ms(torch, rms, rms_inputs, 50)
        log(f"[timing] rmsnorm_bwd {(N, d, dtype)}: F.rms_norm's backward "
            f"alone {t['library_ms']:.6f} ms")
        times[("rmsnorm_bwd", N, d, dtype)] = t
    for N, d, dtype in shapes["add_rmsnorm_bwd"]:
        x, dy, sc = _add_norm_inputs(torch, N, d, dtype)
        g = torch.Generator(device="cuda").manual_seed(N + 7 * d)
        gs = _randn(torch, (N, d), dtype, g)
        nbytes = 4 * x.numel() * x.element_size()
        nxt = _cold_copies((x, sc, gs, dy), nbytes)
        fns = {"kernel": lambda: rn.add_rmsnorm_bwd(*nxt()),
               "plain": lambda: ref.add_rmsnorm_bwd_ref(*nxt()),
               "library": None,
               "kernel_warm": lambda: rn.add_rmsnorm_bwd(x, sc, gs, dy)}
        t = _time_set(torch, "add_rmsnorm_bwd", (N, d, dtype), fns,
                      _cost().norm_bwd_bound(N, d, x.element_size(),
                                             True), 50)
        lib_nxt = _cold_copies((x, dy, sc, gs), nbytes)

        def lib_inputs():
            a, b, c, e = lib_nxt()
            return (a, b, c), (e, b)
        t["library_ms"] = _backward_ms(torch, add_rms, lib_inputs, 50)
        log(f"[timing] add_rmsnorm_bwd {(N, d, dtype)}: the backward alone "
            f"of x + delta then F.rms_norm {t['library_ms']:.6f} ms")
        times[("add_rmsnorm_bwd", N, d, dtype)] = t
    phase_norm_bwd_split(torch, sorted(set(shapes["rmsnorm_bwd"])
                                       | set(shapes["add_rmsnorm_bwd"])))
    sdpa = _sdpa(torch)
    for key in shapes["flash_attention_bwd"]:
        B, H, KV, S, hd, window, dtype, layout = key
        q, k, v = _flash_inputs(torch, B, H, KV, S, hd, dtype, layout)
        o, lse = fa._launch(q, k, v, True, window, with_lse=True)
        g = torch.Generator(device="cuda").manual_seed(S * hd + 1)
        do = _randn(torch, (B, S, H, hd), dtype, g).transpose(1, 2)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
        nxt = _cold_copies((q, k, v, o, lse, do), nbytes)
        fns = {"kernel": lambda: fa.flash_attention_bwd(
                   *nxt(), sliding_window=window),
               "plain": lambda: ref.flash_attention_bwd_ref(
                   *nxt(), sliding_window=window),
               "library": None,
               "kernel_warm": lambda: fa.flash_attention_bwd(
                   q, k, v, o, lse, do, sliding_window=window)}
        t = _time_set(torch, "flash_attention_bwd", key, fns,
                      _cost().flash_bwd_bound(*key[:7],
                                              q.element_size()), 10)
        lib_nxt = _cold_copies((q, k, v, do), nbytes)

        def sdpa_inputs():
            a, b, c, e = lib_nxt()
            return (a, b, c), e
        t["library_ms"] = _backward_ms(
            torch, lambda a, b, c: sdpa(a, b, c, window), sdpa_inputs, 10)
        log(f"[timing] flash_attention_bwd {key}: SDPA's backward alone "
            f"{t['library_ms']:.6f} ms")
        kernel_split(torch, f"flash_attention_bwd {key}",
                     lambda: fa.flash_attention_bwd(
                         q, k, v, o, lse, do, sliding_window=window), 10)
        times[("flash_attention_bwd", *key)] = t
        # the forward with and without its lse output
        nxt_f = _cold_copies((q, k, v), (2 * q.numel() + 2 * k.numel())
                             * q.element_size())
        with_lse = _graph_ms(torch, lambda: fa._launch(
            *nxt_f(), True, window, with_lse=True), 10)
        without = _graph_ms(torch, lambda: fa._launch(
            *nxt_f(), True, window), 10)
        times[("flash_attention_lse", *key)] = {"ms": with_lse,
                                                "ms_without": without}
        log(f"[timing] flash_attention forward {key}: {with_lse:.6f} ms "
            f"with lse, {without:.6f} ms without")
    return times


def path_times(times, launches_by_key):
    """One kernel's times over a path, each the mean over the shapes it ran
    at weighted by its launches there; bound_by is that of the shape with
    the most launches. launches_by_key: {key of `times`: launches}."""
    total = sum(launches_by_key.values())
    out = {k: sum(times[key][k] * n for key, n in launches_by_key.items())
           / total
           for k in ("ms", "plain_ms", "bound_ms", "eager_ms",
                     "plain_eager_ms")}
    warm = [times[key].get("warm_ms") for key in launches_by_key]
    if None not in warm:
        out["warm_ms"] = sum(w * n for w, n in zip(
            warm, launches_by_key.values())) / total
    libs = [times[key].get("library_ms") for key in launches_by_key]
    out["library_ms"] = (None if None in libs else
                         sum(times[key]["library_ms"] * n for key, n in
                             launches_by_key.items()) / total)
    out["bound_by"] = times[max(launches_by_key,
                                key=launches_by_key.get)]["bound_by"]
    return out


# ---------------------------------------------------------------------- #
# 13. the mesh-sharded path
# ---------------------------------------------------------------------- #
# 13c's shapes (bf16): kd_loss rows (N, V), rmsnorm (N, d), flash (B, H, KV,
# S, hd); 13d's decode function at qwen2-vl-2b's decode shape, and its
# 2-layer model cut (prompt, new tokens, cache slots)
SHARDED = {"rounds": 3, "kd": (2048, 151936), "rms": (2048, 3584),
           "flash": ((4, 32, 32, 512, 112), (4, 24, 8, 512, 128)),
           "decode": {"B": 4, "H": 12, "KV": 2, "hd": 128, "L": 32768},
           "cut": {"arch": "qwen2-vl-2b", "n_layers": 2, "B": 4,
                   "prompt": 512, "n_new": 16, "max_len": 1024},
           "groups": (2, 4), "moe_tokens": (2, 64), "timeout_s": 300,
           # 13b's (clients, sizes, intensities) held sharded against batched
           # at atol 1e-5 / rtol 1e-4 (tests/test_torch_sharded.py's): the
           # reference's MESH_PARITY cohort, four one-client groups, so that
           # rank 1 of 2 trains padding rows only; and four clients of batch
           # 32 in one (size, batch, 4-step) group, so that each rank trains
           # two real clients, one of them on masked steps
           "parity_cohorts": {
               "mesh_parity": ([0, 1, 2, 3], ["small", "small", "large",
                                              "large"], [1, 3, 2, 1]),
               "one_group": ([0, 1, 2, 4], ["small"] * 4, [3, 4, 4, 3])}}


class _Axes:
    """The axis sizes of a (data=G, model=1) mesh: what the grouped MoE
    dispatch reads (models.moe._moe_groups), with no process group."""

    def __init__(self, data):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": 1}


def _flat_globals(torch, server):
    from repro_torch.utils.pytree import tree_leaves
    return torch.cat([t.detach().float().cpu().reshape(-1) for t in
                      tree_leaves([server.lite_params,
                                   server.global_by_size])])


def phase_sharded_world1(torch, card):
    """13a: engine="sharded" over a one-rank NCCL group against the batched
    engine, 3 rounds each from the same seed. Returns the sharded engine's
    launches."""
    import copy
    import torch.distributed as dist
    from repro_torch.fl import FLEnvironment, HAPFLServer
    from repro_torch.kernels import kd_loss as kd
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(device="cuda")
    backend = dist.get_backend()
    if backend != "nccl":
        raise SystemExit(f"chip_smoke: 13a's one-rank group is {backend}, "
                         f"the rule says nccl")
    runs = {}
    base = FLEnvironment(main_path_config())
    try:
        with full_fp32(torch):
            for engine in ("batched", "sharded"):
                kw = ({"mesh": mesh} if engine == "sharded"
                      else {"engine": "batched"})
                server = HAPFLServer(copy.deepcopy(base), seed=0,
                                     device="cuda", **kw)
                reset_all_launches()
                recs, secs = [], []
                for _ in range(SHARDED["rounds"]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    recs.append(server.run_round())
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                runs[engine] = (recs, secs, kd.launches["kd_loss_grad"],
                                _flat_globals(torch, server), server.engine)
    finally:
        dist.destroy_process_group()
    (ra, sa, la, ga, ea), (rb, sb, lb, gb, eb) = (
        runs["batched"], runs["sharded"])
    if (ea, eb) != ("batched", "sharded"):
        raise SystemExit(f"chip_smoke: 13a engines {ea}, {eb}")
    for a, b in zip(ra, rb):
        if (a.sizes, a.intensities) != (b.sizes, b.intensities):
            raise SystemExit(f"chip_smoke: 13a round {a.round_idx}: sizes / "
                             f"intensities {a.sizes} {a.intensities} != "
                             f"{b.sizes} {b.intensities}")
    if not torch.equal(ga, gb):
        raise SystemExit(f"chip_smoke: 13a globals differ, max|diff| "
                         f"{float((ga - gb).abs().max())}")
    if la != lb or la == 0:
        raise SystemExit(f"chip_smoke: 13a kd_loss_grad launches batched "
                         f"{la}, sharded {lb}")
    log(f"[sharded 13a] world 1, {backend}: {SHARDED['rounds']} rounds, "
        f"sizes and intensities equal, globals bitwise equal, kd_loss_grad "
        f"launches {la} each; seconds a round batched "
        f"{[round(x, 3) for x in sa]}, sharded {[round(x, 3) for x in sb]} "
        f"({card})")
    return {"kd_loss_grad": lb}


def _rank_share(rec, env, world):
    """{(C_p / world, B, V): launches} of one rank in one round: one
    kd_loss_grad a padded step of every size group, on its rows."""
    from repro_torch.fl.batched import next_pow2
    from repro_torch.fl.sharded import pad_to_mesh
    bpe = env.cfg.batches_per_epoch
    groups = {}
    for c, s, tau in zip(rec.clients, rec.sizes, rec.intensities):
        key = (s, env.loaders[c].batch_size, next_pow2(tau * bpe))
        groups.setdefault(key, []).append(tau * bpe)
    out = {}
    for (_, batch, _), steps in groups.items():
        shape = (pad_to_mesh(len(steps), world) // world, batch,
                 env.n_classes)
        out[shape] = out.get(shape, 0) + next_pow2(max(steps))
    return out


def _rank_cohort(torch, dev, out):
    """13b on one rank. One round of phase 4's config with engine="sharded"
    over the world, and one with the batched engine on this rank, from the
    same seed; the batched engine's own distance between its padded and its
    exact client count on the same cohort. Then SHARDED's parity cohorts
    sharded against batched. Returns the sharded round's flat globals."""
    import copy
    import torch.distributed as dist
    from repro_torch.fl import (BatchedClientEngine, FLEnvironment,
                                FLSimConfig, HAPFLServer, ShardedClientEngine)
    from repro_torch.launch.mesh import make_debug_mesh
    world = dist.get_world_size()
    mesh = make_debug_mesh()
    # one environment built, a fresh copy for each use: every copy's data
    # streams start where the first's did
    base = FLEnvironment(main_path_config())
    runs = {}
    for engine in ("sharded", "batched"):
        kw = {"mesh": mesh} if engine == "sharded" else {"engine": "batched"}
        server = HAPFLServer(copy.deepcopy(base), seed=0, device=dev, **kw)
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = server.run_round()
        torch.cuda.synchronize()
        runs[engine] = (rec, time.perf_counter() - t0,
                        all_launches()["kd_loss_grad"],
                        _flat_globals(torch, server))
    (rs, ss, ls, gs), (rb, sb, lb, gb) = runs["sharded"], runs["batched"]
    share = _rank_share(rs, server.env, world)

    def cohort(engine, env, args, **kw):
        init = HAPFLServer(copy.deepcopy(env), seed=0, engine="batched",
                           device=dev)
        got = engine(copy.deepcopy(env)).train_cohort(
            *args, init.global_by_size, init.lite_params, **kw)
        return torch.cat([t.detach().reshape(-1) for p in got
                          for t in _leaves(p)])

    def batched(env):
        return BatchedClientEngine(env, device=dev)

    def sharded(env):
        return ShardedClientEngine(env, mesh=mesh, device=dev)
    plan = (rs.clients, rs.sizes, rs.intensities)
    yard = float((cohort(batched, base, plan)
                  - cohort(batched, base, plan, pad_clients=False)
                  ).abs().max())
    ref_env = FLEnvironment(FLSimConfig(
        dataset="mnist", n_train=400, n_test=100, batches_per_epoch=1,
        default_epochs=2, n_clients=6, k_per_round=4,
        size_names=("small", "large")))
    parity = {}
    for name, args in SHARDED["parity_cohorts"].items():
        a, b = (cohort(e, ref_env, args) for e in (sharded, batched))
        parity[name] = {
            "close": bool(torch.allclose(a, b, atol=1e-5, rtol=1e-4)),
            "err": float((a - b).abs().max())}
    out["cohort"] = {
        "seconds": [ss, sb], "sizes": [rs.sizes, rb.sizes],
        "intensities": [rs.intensities, rb.intensities],
        "launches": ls, "batched_launches": lb,
        "expected": sum(share.values()),
        "by_shape": {str(k): n for k, n in share.items()},
        "globals_err": float((gs - gb).abs().max()),
        "acc_flips": sum(rs.client_acc[c][k] != rb.client_acc[c][k]
                         for c in rs.client_acc for k in ("local", "lite")),
        "yardstick": yard, "parity": parity}
    return gs


def _leaves(tree):
    from repro_torch.utils.pytree import tree_leaves
    return tree_leaves(tree)


def _rank_kernels(torch, dev, out):
    """13c on one rank: each sharded wrapper against its kernel on the whole
    tensor, bitwise, and that kernel against its plain version at phase 3's
    tolerance (the kd forward at V 151936 is no shape of phase 3's); the
    launches of the sharded call alone."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import (flash_attention_op, kd_loss_op,
                                         rmsnorm_op)
    from repro_torch.kernels.sharded import (sharded_flash_attention,
                                             sharded_kd_loss, sharded_rmsnorm)
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh()
    g = torch.Generator(dev).manual_seed(13)
    bf16 = "bfloat16"
    N, V = SHARDED["kd"]
    x, y = (_randn(torch, (N, V), bf16, g, 2.0) for _ in range(2))
    lab = torch.randint(0, V, (N,), generator=g, device=dev)
    h = _randn(torch, SHARDED["rms"], bf16, g)
    scale = _randn(torch, SHARDED["rms"][1:], bf16, g)
    # {name: (sharded call, unsharded kernel, plain version, tolerance)};
    # the kd forward's terms stacked (4, N) as its plain version gives them
    cases = {"kd_loss_fwd": (
        lambda: sharded_kd_loss(x, y, lab, mesh),
        lambda: torch.stack([kd_loss_op(x, y, lab)[t] for t in TERMS]),
        lambda: ref.kd_loss_fwd_ref(x, y, lab)[0], TOL["float32"]),
        "rmsnorm": (lambda: sharded_rmsnorm(h, scale, mesh),
                    lambda: rmsnorm_op(h, scale),
                    lambda: ref.rmsnorm_ref(h, scale), TOL_NORM[bf16])}
    for B, H, KV, S, hd in SHARDED["flash"]:
        q = _randn(torch, (B, H, S, hd), bf16, g)
        k, v = (_randn(torch, (B, KV, S, hd), bf16, g) for _ in range(2))
        cases[f"flash_attention {(B, H, KV, S, hd)}"] = (
            lambda q=q, k=k, v=v: sharded_flash_attention(q, k, v, mesh),
            lambda q=q, k=k, v=v: flash_attention_op(q, k, v),
            lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v),
            TOL_FLASH[bf16])
    res = {}
    with torch.no_grad():
        for name, (sharded, whole, plain, tol) in cases.items():
            reset_all_launches()
            got = sharded()
            torch.cuda.synchronize()
            launches = {k: n for k, n in all_launches().items() if n}
            if isinstance(got, dict):
                got = torch.stack([got[t] for t in TERMS])
            want = whole()
            exp = plain().float()
            res[name] = {
                "equal": torch.equal(got, want), "launches": launches,
                "plain_close": bool(torch.allclose(want.float(), exp,
                                                   atol=tol, rtol=tol)),
                "plain_err": float((want.float() - exp).abs().max()),
                "tol": tol}
            del got, want, exp
    out["kernels"] = res


def _rank_decode(torch, dev, out):
    """13d on one rank: the sharded flash decode's function against plain
    attention over the whole cache; a 2-layer cut of qwen2-vl-2b decoded on
    a (1, 4) mesh against no mesh."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.axes import use_axis_rules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.models.attention import (flash_decode_sharded,
                                              gqa_attention)
    world = dist.get_world_size()
    mesh = make_debug_mesh(model=world)
    d = SHARDED["decode"]
    B, H, KV, hd, L = d["B"], d["H"], d["KV"], d["hd"], d["L"]
    Ls = L // world
    slot = 2 * Ls + Ls // 2                    # in the third slice
    mine = slice(dist.get_rank() * Ls, (dist.get_rank() + 1) * Ls)
    fn = {}
    for name in ("float32", "bfloat16"):
        g = torch.Generator(dev).manual_seed(17)
        q, kn, vn = (_randn(torch, (B, 1, n, hd), name, g)
                     for n in (H, KV, KV))
        ck, cv = (_randn(torch, (B, L, KV, hd), name, g) for _ in range(2))
        part_k, part_v = ck[:, mine].clone(), cv[:, mine].clone()
        before = part_k.clone()
        pos = torch.tensor(slot, device=dev)
        got = flash_decode_sharded(q, part_k, part_v, kn, vn, pos, pos + 1,
                                   mesh)
        ck[:, slot], cv[:, slot] = kn[:, 0], vn[:, 0]
        want = gqa_attention(q, ck, cv, causal=False, kv_len_valid=pos + 1,
                             q_start=pos)
        fn[name] = {"err": float((got.float() - want.float()).abs().max()),
                    "wrote": not torch.equal(part_k, before),
                    "slice_ok": torch.equal(part_k, ck[:, mine])
                    and torch.equal(part_v, cv[:, mine])}
        del q, kn, vn, ck, cv, part_k, part_v, before, got, want
    out["decode_fn"] = fn

    c = SHARDED["cut"]
    cfg = dataclasses.replace(get_config(c["arch"]),
                              n_layers=c["n_layers"], dtype=torch.float32)
    params = api.init_model(torch.Generator(dev).manual_seed(19), cfg, dev)
    batch = api.dummy_batch(cfg, c["B"], c["prompt"] + c["n_new"],
                            torch.Generator(dev).manual_seed(23),
                            with_labels=False, device=dev)
    S = c["prompt"]
    runs, counts = {}, {}
    for name, m in (("mesh", mesh), ("plain", None)):
        ctx = use_axis_rules(m) if m is not None else contextlib.nullcontext()
        logits = []
        reset_all_launches()
        with ctx, torch.no_grad():
            _, pre = api.prefill(params, cfg, {
                "embeddings": batch["embeddings"][:, :S],
                "positions": batch["positions"][:, :, :S]})
            cache = api.make_decode_cache(cfg, c["B"], c["max_len"], dev)
            api.fill_decode_cache(cfg, cache, pre)
            for t in range(S, S + c["n_new"]):
                lg, cache = api.decode_step(
                    params, cfg, {"embeddings": batch["embeddings"][:, t:t + 1]},
                    cache, t)
                logits.append(lg)
        torch.cuda.synchronize()
        counts[name] = {k: n for k, n in all_launches().items() if n}
        runs[name] = (torch.stack(logits), tuple(cache["blocks"]["k"].shape))
    out["decode_cut"] = {
        "err": float((runs["mesh"][0] - runs["plain"][0]).abs().max()),
        "cache": runs["mesh"][1], "plain_cache": runs["plain"][1],
        "launches": counts["mesh"], "plain_launches": counts["plain"]}


def _rank_main(rank, world, port, out_dir):
    """One rank of a gloo world on the one card: its sub-phases' results
    into rank<r>.json (13b's globals into rank<r>.pt)."""
    import os
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, dev = init_world(rank, world, f"tcp://localhost:{port}",
                              device="cuda")
    out = {"backend": backend, "device": str(dev)}
    import torch.distributed as dist
    try:
        if world == 2:
            torch.save(_rank_cohort(torch, dev, out),
                       Path(out_dir) / f"rank{rank}.pt")
            _rank_kernels(torch, dev, out)
        else:
            _rank_decode(torch, dev, out)
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(world, out_dir, target=None, during=None):
    """Run `target` (_rank_main when None) on `world` spawned processes,
    each writing rank<r>.json, and `during()` in this process while they
    run; a rank that fails, `during` raising, or a world that outlives
    SHARDED's timeout fails the script (the other ranks are terminated)."""
    import torch.multiprocessing as mp
    timeout_s = SHARDED["timeout_s"]
    t0 = time.perf_counter()
    ctx = mp.spawn(target or _rank_main,
                   args=(world, _free_port(), str(out_dir)),
                   nprocs=world, join=False)
    try:
        if during is not None:
            during()
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > timeout_s:
                raise SystemExit(f"chip_smoke: the world of {world} ranks "
                                 f"did not end in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return ([json.loads((Path(out_dir) / f"rank{r}.json").read_text())
             for r in range(world)], time.perf_counter() - t0)


def phase_sharded_ranks(torch, card):
    """13b-13d: worlds of 2 and 4 gloo ranks on the one card. Returns the
    ranks' launches by sub-phase."""
    import tempfile
    from collections import Counter
    with tempfile.TemporaryDirectory() as tmp:
        w2, s2 = spawn_ranks(2, tmp)
        g = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
        w4, s4 = spawn_ranks(4, tmp)
    for ranks in (w2, w4):
        if {r["backend"] for r in ranks} != {"gloo"}:
            raise SystemExit(f"chip_smoke: ranks on one card must run gloo, "
                             f"got {[r['backend'] for r in ranks]}")
    # 13b
    for r, res in enumerate(w2):
        c = res["cohort"]
        if c["sizes"][0] != c["sizes"][1] or (
                c["intensities"][0] != c["intensities"][1]):
            raise SystemExit(f"chip_smoke: 13b rank {r}: sizes / intensities "
                             f"differ from the batched engine's")
        if c["launches"] != c["expected"]:
            raise SystemExit(f"chip_smoke: 13b rank {r}: kd_loss_grad "
                             f"launches {c['launches']} != {c['expected']} "
                             f"({c['by_shape']})")
        for name, par in c["parity"].items():
            if not par["close"]:
                raise SystemExit(f"chip_smoke: 13b rank {r}: the {name} "
                                 f"cohort sharded is {par['err']} from "
                                 f"batched (atol 1e-5, rtol 1e-4)")
    if not torch.equal(g[0], g[1]):
        raise SystemExit("chip_smoke: 13b the ranks' globals differ")
    c = w2[0]["cohort"]
    parity = ", ".join(
        f"{name} cohort "
        f"{max(r['cohort']['parity'][name]['err'] for r in w2):.3e}"
        for name in SHARDED["parity_cohorts"])
    log(f"[sharded 13b] world 2, gloo on {w2[0]['device']}: one round of "
        f"phase 4's config, sizes {c['sizes'][0]}, intensities "
        f"{c['intensities'][0]}: the ranks' globals bitwise equal; max|diff| "
        f"to the batched engine's round {c['globals_err']:.3e} "
        f"({c['acc_flips']} of {2 * len(c['sizes'][0])} client accuracies "
        f"differ), where the batched engine alone differs from itself by "
        f"{c['yardstick']:.3e} between its padded and its exact client "
        f"count on this cohort; kd_loss_grad launches a rank "
        f"{[r['cohort']['launches'] for r in w2]} (batched "
        f"{c['batched_launches']}) by (C_p / 2, B, V) {c['by_shape']}; "
        f"seconds a round sharded / batched "
        f"{[[round(x, 3) for x in r['cohort']['seconds']] for r in w2]}; "
        f"sharded vs batched max|diff| (atol 1e-5, rtol 1e-4) "
        f"{parity}; the world {s2:.2f} s with its start ({card})")
    # 13c
    for r, res in enumerate(w2):
        for name, k in res["kernels"].items():
            kernel = name.split()[0]
            if (not k["equal"] or not k["plain_close"]
                    or k["launches"] != {kernel: 1}):
                raise SystemExit(f"chip_smoke: 13c rank {r} {name}: equal "
                                 f"{k['equal']}, max|diff| to the plain "
                                 f"version {k['plain_err']} (tol {k['tol']}), "
                                 f"launches {k['launches']}")
    log(f"[sharded 13c] world 2: each sharded call bitwise equal to the "
        f"unsharded kernel, one launch a rank; the kernel's max|diff| to its "
        f"plain version (bf16) " + ", ".join(
            f"{name} {max(r['kernels'][name]['plain_err'] for r in w2):.3e} "
            f"({k['tol']})" for name, k in w2[0]["kernels"].items())
        + f" ({card})")
    # 13d
    for r, res in enumerate(w4):
        for name, f in res["decode_fn"].items():
            tol = 1e-5 if name == "float32" else 2e-3
            if f["err"] > tol or not f["slice_ok"]:
                raise SystemExit(f"chip_smoke: 13d rank {r} {name}: err "
                                 f"{f['err']} (tol {tol}), slice {f['slice_ok']}")
        cut = res["decode_cut"]
        if cut["err"] > 1e-4:
            raise SystemExit(f"chip_smoke: 13d rank {r}: cut logits err "
                             f"{cut['err']} > 1e-4")
        # without a mesh the decode attends through the decode-attention
        # kernel, once a layer a step; on the mesh through the sharded
        # function, which is plain PyTorch; every other launch is the same
        steps = SHARDED["cut"]["n_layers"] * SHARDED["cut"]["n_new"]
        plain = dict(cut["plain_launches"])
        if (plain.pop("decode_attention", 0) != steps
                or "decode_attention" in cut["launches"]
                or cut["launches"] != plain or not cut["launches"]):
            raise SystemExit(f"chip_smoke: 13d rank {r}: launches "
                             f"{cut['launches']} on the mesh, "
                             f"{cut['plain_launches']} without (decode "
                             f"attention {steps} expected there only)")
    wrote = [[res["decode_fn"][n]["wrote"] for res in w4]
             for n in ("float32", "bfloat16")]
    if wrote != [[False, False, True, False]] * 2:
        raise SystemExit(f"chip_smoke: 13d the new k/v landed in {wrote}")
    log(f"[sharded 13d] world 4, gloo: flash_decode_sharded at (B, H, KV, "
        f"hd, L) {tuple(SHARDED['decode'].values())} against gqa_attention "
        f"over the whole cache, max|diff| fp32 "
        f"{max(r['decode_fn']['float32']['err'] for r in w4):.3e} (1e-5), "
        f"bf16 {max(r['decode_fn']['bfloat16']['err'] for r in w4):.3e} "
        f"(2e-3), the new k/v in rank 2's slice only; the "
        f"{SHARDED['cut']['n_layers']}-layer fp32 cut of "
        f"{SHARDED['cut']['arch']}: prefill {SHARDED['cut']['prompt']} + "
        f"{SHARDED['cut']['n_new']} steps on a (1, 4) mesh, cache slice "
        f"{w4[0]['decode_cut']['cache']} of {w4[0]['decode_cut']['plain_cache']}"
        f", logits max|diff| {max(r['decode_cut']['err'] for r in w4):.3e} "
        f"(1e-4) to no mesh, launches a rank {w4[0]['decode_cut']['launches']}"
        f"; the world {s4:.2f} s with its start ({card})")
    return {"13b": [{"kd_loss_grad": r["cohort"]["launches"]} for r in w2],
            "13c": [dict(sum((Counter(k["launches"])
                              for k in r["kernels"].values()), Counter()))
                    for r in w2],
            "13d": [r["decode_cut"]["launches"] for r in w4]}


def phase_moe_groups(torch, card):
    """13e: the grouped MoE dispatch on a 2-layer fp32 cut of
    qwen3-moe-30b-a3b at full width, the blocks' forward at G = 2 and 4 on
    the card and on the CPU: routes and kept pairs equal at every MoE call,
    y at 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.axes import use_axis_rules
    from repro_torch.models import moe, transformer
    from repro_torch.models.api import init_model
    import numpy as np
    cfg = dataclasses.replace(get_config(MOE["arch"]),
                              n_layers=MOE["parity_layers"],
                              dtype=torch.float32)
    gpu = init_model(torch.Generator("cuda").manual_seed(29), cfg, "cuda")
    sides = {"cuda": gpu,
             "cpu": params_from_numpy(params_to_numpy(gpu), device="cpu")}
    B, S = SHARDED["moe_tokens"]
    tok = np.random.default_rng(29).integers(0, cfg.vocab_size, (B, S))
    slots, apply = moe.dispatch_slots, transformer.apply_moe
    log_line = []
    for G in SHARDED["groups"]:
        calls, side = {"cuda": [], "cpu": []}, ["cuda"]
        kept, ys = {"cuda": [], "cpu": []}, {"cuda": [], "cpu": []}

        def rec_slots(*a):
            out = slots(*a)
            kept[side[0]].append(out[1].cpu())
            return out

        def rec_apply(*a):
            out = apply(*a)
            ys[side[0]].append(out[0].detach().cpu())
            return out
        moe.dispatch_slots, transformer.apply_moe = rec_slots, rec_apply
        try:
            with full_fp32(torch), torch.no_grad(), \
                    recorded_routes(calls, side), use_axis_rules(_Axes(G)):
                for dev, params in sides.items():
                    side[0] = dev
                    reset_all_launches()
                    transformer.apply_blocks(params, cfg, {
                        "tokens": torch.as_tensor(tok, device=dev)})
        finally:
            moe.dispatch_slots, transformer.apply_moe = slots, apply
        gap = compare_routes(torch, calls, cfg.n_layers, f"moe G={G}")
        if [k.shape[0] for k in kept["cuda"]] != [G] * cfg.n_layers:
            raise SystemExit(f"chip_smoke: 13e G={G}: dispatch groups "
                             f"{[k.shape for k in kept['cuda']]}")
        for i, (a, b) in enumerate(zip(kept["cuda"], kept["cpu"])):
            if not torch.equal(a, b):
                raise SystemExit(f"chip_smoke: 13e G={G}: kept pairs differ "
                                 f"at MoE call {i}")
        err = _assert_trees_close(torch, ys["cuda"], ys["cpu"], 1e-3,
                                  f"13e G={G} y")
        dropped = [round(1 - float(k.float().mean()), 4) for k in kept["cpu"]]
        log_line.append(f"G {G}: routes and kept pairs equal at all "
                        f"{len(kept['cpu'])} calls (least gap {gap:.3e}), y "
                        f"max|diff| {err:.3e}, dropped share {dropped}")
    del sides, gpu
    free_device_memory(torch)
    log(f"[sharded 13e] {cfg.n_layers}-layer fp32 cut of {MOE['arch']}, "
        f"{B} x {S} tokens, card vs CPU (atol 1e-3): " + "; ".join(log_line)
        + f" ({card})")


def phase_sharded(torch, card):
    """Phase 13, with its wall time."""
    t0 = time.perf_counter()
    launches = {"13a": [phase_sharded_world1(torch, card)],
                **phase_sharded_ranks(torch, card)}
    phase_moe_groups(torch, card)
    wall = time.perf_counter() - t0
    log(f"[sharded] phase 13 wall {wall:.2f} s ({card})")
    return launches


def add_sharded_launches(record, launches):
    """Each kernel row of the record gets its phase-13 launches by rank and
    sub-phase ({sub-phase: [{kernel: launches}] a rank})."""
    for row in record["kernels"]:
        got = {sub: [r.get(row["name"], 0) for r in ranks]
               for sub, ranks in launches.items()}
        got = {sub: n for sub, n in got.items() if any(n)}
        if got:
            row["sharded"] = {
                "launches_by_rank": got,
                "path": "phase 13: 13a engine=sharded on a one-rank NCCL "
                        "group, 13b-13d gloo ranks on the one card"}


# ---------------------------------------------------------------------- #
# 14. the launch tooling: the dry run of each measured path, the sharding
# rules on real weights, mixtral-8x7b's placement on meta
# ---------------------------------------------------------------------- #
#: the paths served and trained above, by tag: their config, the launches
#: the card counted and the measured times (phase_serve, phase_train)
PATHS = {}
#: 14b: llama3.2-3b at full width cut to `layers`, sharded at each world
LAUNCH = {"arch": "llama3.2-3b", "layers": 1, "worlds": (2, 4),
          "seed": 0, "mixtral": "mixtral-8x7b", "node_mesh": (1, 8)}


def dryrun_path(torch, tag, path):
    """14a for one measured path: the dry run of its step(s) on meta at its
    own config and shapes, the kernel calls held against the card's
    launches, the roofline terms beside the measured times. A decode step's
    share and mfu are over the graph's replay device time, the steadier
    reading; over the wall-clock difference of two generate lengths too."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import MeshShape
    cfg = path["cfg"]
    one = MeshShape((1, 1), ("data", "model"))
    # a stack with no tail is extrapolated exactly from 1 and 2 units
    probes = dryrun._unit_layout(cfg)[2] == 0
    # part: (shape, the measured seconds by name, the times the card ran it)
    if path["mode"] == "serve":
        parts = {"prefill": (ShapeConfig("serve_prefill", SERVE["prompt"],
                                         SERVE["batch"], "prefill"),
                             {"wall": path["prefill_ms"] / 1e3}, 1),
                 "decode": (ShapeConfig("serve_decode", SERVE["max_len"],
                                        SERVE["batch"], "decode"),
                            {"replay": path["replay_ms"] / 1e3,
                             "wall": path["decode_ms"] / 1e3},
                            SERVE["n_new"])}
    else:
        parts = {"step": (ShapeConfig("train", TRAIN["seq"],
                                       TRAIN["batch"], "train"),
                           {"wall": path["step_s"]}, path["steps"])}
    expected = {}
    for part, (shape, measured, times) in parts.items():
        t0 = time.perf_counter()
        res = dryrun.dry_run(cfg, shape, one, probes=probes)
        count_s = time.perf_counter() - t0
        for name, k in res["kernels"].items():
            calls = k["calls"]
            if abs(calls - round(calls)) > 1e-9:
                raise SystemExit(f"chip_smoke: 14a {tag} {part}: {calls} "
                                 f"{name} calls is not whole")
            expected[name] = expected.get(name, 0) + times * round(calls)
        least_s = max(res["compute_s"], res["memory_s"])
        model_s = res["model_flops_total"] / HW["peak_flops_bf16"]
        shares = "; ".join(
            f"{how} {secs * 1e3:.3f} ms: roofline share "
            f"{100 * least_s / secs:.2f}%, mfu {100 * model_s / secs:.3f}%"
            for how, secs in measured.items())
        log(f"[launch] 14a {tag} {part} ({cfg.name}, {shape.global_batch} "
            f"x {shape.seq_len}): dry run (counted in {count_s:.2f} s on "
            f"meta, probes {probes}): {res['flops_total']:.6e} FLOPs, "
            f"{res['bytes_total']:.6e} B, compute_s "
            f"{res['compute_s'] * 1e3:.4f} ms, memory_s "
            f"{res['memory_s'] * 1e3:.4f} ms ({res['dominant']}), model "
            f"{res['model_flops_total']:.6e} FLOPs; measured {shares}; "
            f"kernels (calls, FLOPs and bytes a call) "
            + ", ".join(f"{k} {v['calls']:g} ({v['flops'] / v['calls']:.6e}"
                        f", {v['bytes'] / v['calls']:.6e})"
                        for k, v in res["kernels"].items()))
    # on meta leaves the optimizer takes its plain version, so the dry run
    # counts none of its kernels: phase 9 holds those launches exactly
    counted = {k: n for k, n in path["launches"].items()
               if n and k not in OPT_KERNELS}
    if counted != expected:
        raise SystemExit(f"chip_smoke: 14a {tag}: the dry run counts "
                         f"{expected} kernel calls, the card launched "
                         f"{counted}")
    log(f"[launch] 14a {tag}: the dry run's kernel calls equal the card's "
        f"launches {counted}")


def _rank_launch(rank, world, port, out_dir):
    """One rank of 14b: llama3.2-3b at full width (LAUNCH's layers) on the
    card, its params, AdamW state (m and v drawn at random) and a decode
    cache (drawn at random) sharded and gathered back on a (1, w) and a
    (w, 1) mesh. Results into rank<r>.json."""
    import os
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import collective_formula
    from repro_torch.launch.hlo_analysis import collective_stats
    from repro_torch.launch.mesh import _mesh, axis_sizes, init_world
    from repro_torch.models.api import make_decode_cache
    from repro_torch.train import make_train_state
    from repro_torch.utils.pytree import tree_leaves
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    backend, dev = init_world(rank, world, f"tcp://localhost:{port}",
                              device="cuda")
    out = {"backend": backend, "device": str(dev), "meshes": {}}
    try:
        cfg = dataclasses.replace(get_config(LAUNCH["arch"]),
                                  n_layers=LAUNCH["layers"])
        gen = torch.Generator(dev).manual_seed(LAUNCH["seed"])
        state = make_train_state(gen, cfg, cfg.lite(), device=dev)
        B = SERVE["batch"]
        cache = make_decode_cache(cfg, B, SERVE["max_len"], dev)
        for leaf in tree_leaves(state["opt"]) + tree_leaves(cache):
            if leaf.dim():
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=dev).to(leaf.dtype))
        for sizes in ((1, world), (world, 1)):
            mesh = _mesh(sizes, ("data", "model"))
            n_of = axis_sizes(mesh)
            p_sh = sh.params_shardings(state["params"], mesh)
            trees = {"params": (state["params"], p_sh),
                     "opt": (state["opt"], sh.opt_shardings(state["opt"],
                                                           p_sh, mesh)),
                     "cache": (cache, sh.cache_shardings(cache, mesh, B))}
            res = {}
            for name, (tree, specs) in trees.items():
                t0 = time.perf_counter()
                local = sh.shard_tree(tree, specs, mesh)
                with collective_stats() as stats:
                    back = sh.gather_tree(local, specs, mesh)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                pairs = list(zip(tree_leaves(tree), tree_leaves(back)))
                split = [(t.numel() * t.element_size(),
                          sum(1 for e in spec for a in sh.entry_axes(e)
                              if n_of[a] > 1))
                         for t, spec in sh.zip_specs(tree, specs)]
                res[name] = {
                    "bitwise": all(a.dtype == b.dtype and torch.equal(a, b)
                                   for a, b in pairs),
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in tree_leaves(local)),
                    "spec_bytes": sh.tree_bytes(tree, specs, mesh),
                    "whole_bytes": sh.tree_bytes(tree),
                    "gathers": stats.get("all-gather",
                                         {"count": 0, "bytes": 0}),
                    "expected": {"count": sum(d for _, d in split),
                                 "bytes": sum(b for b, d in split if d)},
                    "s": time.perf_counter() - t0}
                if name == "params":
                    res[name]["formula"] = collective_formula(
                        {"params": tree}, {"params": specs},
                        ShapeConfig("prefill", 1, B, "prefill"),
                        mesh).get("all-gather", {"count": 0, "bytes": 0})
                del local, back, pairs
            out["meshes"]["x".join(map(str, sizes))] = res
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def phase_launch_sharding(torch, during=None):
    """14b: the shard -> gather round trip at LAUNCH's worlds, gloo ranks on
    the one card; `during()` runs here while the first world's ranks
    do."""
    import tempfile
    for world in LAUNCH["worlds"]:
        with tempfile.TemporaryDirectory() as tmp:
            ranks, secs = spawn_ranks(world, tmp, _rank_launch, during)
        during = None
        for r, res in enumerate(ranks):
            if res["backend"] != "gloo":
                raise SystemExit(f"chip_smoke: 14b ranks on one card must "
                                 f"run gloo, got {res['backend']}")
            for mesh, trees in res["meshes"].items():
                for name, t in trees.items():
                    bad = [] if t["bitwise"] else ["not bitwise"]
                    if t["bytes"] != t["spec_bytes"]:
                        bad.append(f"{t['bytes']} B held, the specs say "
                                   f"{t['spec_bytes']}")
                    if t["gathers"] != t["expected"]:
                        bad.append(f"gathers {t['gathers']}, expected "
                                   f"{t['expected']}")
                    if name == "params" and t["gathers"] != t["formula"]:
                        bad.append(f"gathers {t['gathers']}, the dry "
                                   f"run's formula {t['formula']}")
                    if bad or not t["gathers"]["count"]:
                        raise SystemExit(f"chip_smoke: 14b world {world} "
                                         f"rank {r} mesh {mesh} {name}: "
                                         f"{bad or 'nothing gathered'}")
        for mesh, trees in ranks[0]["meshes"].items():
            log(f"[launch] 14b world {world}, mesh {mesh}: "
                + "; ".join(f"{name} {t['whole_bytes']} B whole, "
                            f"{t['bytes']} B a rank, {t['gathers']['count']} "
                            f"gathers of {t['gathers']['bytes']} B, "
                            f"{t['s']:.2f} s" for name, t in trees.items())
                + " (bitwise on every rank)")
        log(f"[launch] 14b world {world}: {secs:.2f} s")


def phase_launch_mixtral():
    """14c: mixtral-8x7b's bytes a card, from the specs on meta, on the
    production node mesh."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import input_shardings
    from repro_torch.launch.sharding import MeshShape, tree_bytes
    from repro_torch.launch.specs import input_specs
    cfg = get_config(LAUNCH["mixtral"])
    mesh = MeshShape(LAUNCH["node_mesh"], ("data", "model"))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = INPUT_SHAPES[name]
        specs = input_specs(cfg, shape)
        per = tree_bytes(specs, input_shardings(specs, shape, mesh), mesh)
        log(f"[launch] 14c {cfg.name} {name} on a {LAUNCH['node_mesh']} "
            f"mesh: {per} B a card of {tree_bytes(specs)} B "
            f"({100 * per / HW['hbm_bytes']:.1f}% of "
            f"{HW['hbm_bytes']:.0f} B); running it waits for more than one "
            f"card")


def phase_launch(torch, card):
    """Phase 14, with its wall time: 14a (host work on meta tensors) runs
    while 14b's first world of ranks does."""
    t0 = time.perf_counter()

    def dry_runs():
        for tag, path in PATHS.items():
            dryrun_path(torch, tag, path)
        log(f"[launch] 14a {time.perf_counter() - t0:.2f} s")

    free_device_memory(torch)
    phase_launch_sharding(torch, during=dry_runs)
    phase_launch_mixtral()
    log(f"[launch] phase 14 wall {time.perf_counter() - t0:.2f} s ({card})")


# ---------------------------------------------------------------------- #
def main() -> int:
    import torch
    t_script = time.perf_counter()
    card = phase_device(torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside the "
                         "script: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.cost import HW as card_hw
    HW.update(card_hw)
    phase_build()
    errs = phase_kernels(torch, CHECK_SHAPES)
    bitwise_s = phase_kd_bitwise(torch, KD_BITWISE)
    log(f"[main] the kd bitwise checks: {bitwise_s:.2f} s")
    grad_errs = phase_kd_grad(torch, GRAD_SHAPES + GRAD_SWITCH_SHAPES)
    nf_errs = phase_norm_flash_kernels(torch)
    bwd_errs = phase_bwd_kernels(torch)
    adamw = phase_adamw(torch)
    dec_errs, dec_times = phase_decode_attention(torch)
    nf_errs.update(dec_errs)
    server, launches, shapes = phase_main_path(torch)
    baselines_s = phase_baselines(torch)
    sim_launches, sim_shapes, async_s = phase_async(torch, grad_errs)
    log(f"[main] phases 4b and 4c: baselines {baselines_s:.2f} s, async "
        f"{async_s:.2f} s, {baselines_s + async_s:.2f} s together")
    service_s = phase_service(torch)
    grad_main = [(C, B, V, "float32") for C, B, V in sorted(shapes)]
    grad_errs.update(phase_kd_grad(
        torch, [s for s in grad_main if s not in grad_errs]))
    # kd_loss_fwd / kd_loss_bwd, off the path now, at the path's rows
    rows_main = [(C * B, V, "float32") for C, B, V, _ in grad_main]
    errs.update(phase_kernels(torch, [s for s in rows_main if s not in errs]))
    t_timing = time.perf_counter()
    times = phase_timing(torch, rows_main + VOCAB_SHAPES)
    log(f"[main] the kd timings: {time.perf_counter() - t_timing:.2f} s")
    grad_times = phase_grad_timing(torch, grad_main + GRAD_VOCAB)

    engine, batch, serve_launches, serve_shapes, _ = phase_serve(torch)
    phase_serve_wrap(torch)
    serve_keys = {name: {(name, *shape): n for shape, n in by_shape.items()}
                  for name, by_shape in serve_shapes.items() if by_shape}
    for keys in serve_keys.values():
        unchecked = [k for k in keys if k not in nf_errs]
        if unchecked:
            raise SystemExit(f"chip_smoke: the serve path ran shapes phase "
                             f"3 did not check: {unchecked}")
    nf_times = phase_norm_flash_timing(
        torch, [k[1:] for k in serve_keys["rmsnorm"]],
        [k[1:] for k in serve_keys["add_rmsnorm"]],
        [k[1:] for k in serve_keys["flash_attention"]])

    phase_parity(torch)
    phase_serve_parity(torch)
    phase_profile(torch, "HAPFL round", server.run_round,
                  ("kd_grad_warp_kernel",))
    prof = phase_profile(torch, "generate",
                         lambda: engine.generate(batch, n_new=SERVE["n_new"]),
                         ("norm_kernel", "flash_wgmma_kernel"))
    report_device_gaps(torch, prof, "generate")
    prof = phase_profile(
        torch, "decode loop (graph replays)",
        lambda: decode_loop(torch, engine, SERVE["prompt"], SERVE["n_new"]),
        ("norm_kernel",))
    report_device_gaps(torch, prof, "decode loop (graph replays)")
    with torch.no_grad():
        prof = phase_profile(torch, "prefill",
                             lambda: engine._prefill(engine.params, batch),
                             ("norm_kernel", "flash_wgmma_kernel"),
                             record_shapes=True)
    check_no_layout_copies(torch, prof, engine.cfg)
    del engine, batch, prof
    free_device_memory(torch)

    moe_serve_launches, moe_serve_shapes, moe_serve, moe_serve_s = \
        phase_moe_serve(torch)
    moe_serve_keys = {name: {(name, *shape): n
                             for shape, n in by_shape.items()}
                      for name, by_shape in moe_serve_shapes.items()
                      if by_shape}
    unchecked = [k for keys in moe_serve_keys.values() for k in keys
                 if k not in nf_errs]
    if unchecked:
        raise SystemExit(f"chip_smoke: the MoE serve path ran shapes phase "
                         f"3 did not check: {unchecked}")
    nf_times.update(phase_norm_flash_timing(
        torch, *[[k[1:] for k in moe_serve_keys[name] if k not in nf_times]
                 for name in ("rmsnorm", "add_rmsnorm", "flash_attention")]))
    moe_parity_s = phase_moe_parity(torch)

    state, step, train_batches, train_launches, train_shapes = phase_train(
        torch)
    train_keys = {name: {(name, *shape): n for shape, n in by_shape.items()}
                  for name, by_shape in train_shapes.items() if by_shape}
    checked = {**nf_errs, **bwd_errs,
               **{("kd_loss_grad", *k): e for k, e in grad_errs.items()}}
    unchecked = [k for keys in train_keys.values() for k in keys
                 if k not in checked]
    if unchecked:
        raise SystemExit(f"chip_smoke: the training path ran shapes phase 3 "
                         f"did not check: {unchecked}")
    phase_profile(torch, "training step",
                  lambda: step(state, train_batches[1]),
                  ("flash_bwd_dkdv", "flash_bwd_dq",
                   "flash_bwd_prep_kernel", "norm_bwd_kernel",
                   "norm_kernel", "flash_wgmma_kernel",
                   "kd_grad_row_kernel"))
    ckpt_launches, ckpt_s = phase_train_checkpoint(torch, state,
                                                   train_batches[1])
    log(f"[main] the two new phases: service {service_s:.2f} s, training "
        f"checkpoint {ckpt_s:.2f} s")
    del state, step, train_batches
    free_device_memory(torch)
    moe_train_launches, moe_train_shapes, moe_train_s = phase_moe_train(torch)
    moe_train_keys = {name: {(name, *shape): n
                             for shape, n in by_shape.items()}
                      for name, by_shape in moe_train_shapes.items()
                      if by_shape}
    unchecked = [k for keys in moe_train_keys.values() for k in keys
                 if k not in checked]
    if unchecked:
        raise SystemExit(f"chip_smoke: the MoE training path ran shapes "
                         f"phase 3 did not check: {unchecked}")
    log(f"[main] the MoE phases: serve (5c) {moe_serve_s:.2f} s, parity "
        f"(5d) {moe_parity_s:.2f} s, training (9c) {moe_train_s:.2f} s")
    # the VLM and audio families, after 9c's state is freed: serving (5e,
    # 5f), the card against the CPU (5g), training (9d, 9e)
    fam_keys, fam_launches, fam_serve, fam_walls = {}, {}, {}, {}
    for arch in VLM_AUDIO["archs"]:
        fam = get_config(arch).family
        counted, by_shape, fam_serve[fam], fam_walls[f"{fam} serve"] = \
            phase_family_serve(torch, arch)
        fam_launches[f"{fam}_serve"] = counted
        fam_keys[f"{fam}_serve"] = by_shape
    for arch in VLM_AUDIO["archs"]:
        fam_walls[f"{get_config(arch).family} parity"] = \
            phase_family_parity(torch, arch)
    for arch in VLM_AUDIO["archs"]:
        fam = get_config(arch).family
        counted, by_shape, fam_walls[f"{fam} train"] = phase_family_train(
            torch, arch)
        fam_launches[f"{fam}_train"] = counted
        fam_keys[f"{fam}_train"] = by_shape
    # the SSM family, after 9e's state is freed: xlstm-1.3b served at full
    # width and depth (5h); a 2-layer xlstm cut with its sLSTM, zamba2-7b's
    # smoke cut and its hd-112 cut, the card against the CPU (5i);
    # xlstm-1.3b trained (9f); zamba2-7b served at full width and depth and
    # trained at full width on 12 layers, in bf16 (9g)
    xlstm = get_config(SSM["arch"])
    hybrid = get_config(SSM["hybrid"])
    hybrid_train = dataclasses.replace(hybrid, n_layers=SSM["train_layers"])
    (fam_launches["ssm_serve"], fam_keys["ssm_serve"], fam_serve["ssm"],
     fam_walls["ssm serve (5h)"]) = phase_family_serve(torch, SSM["arch"])
    fam_walls["ssm parity (5i)"] = phase_family_parity(
        torch, SSM["arch"], dataclasses.replace(xlstm, **SSM["parity_cut"]))
    fam_walls["hybrid parity (5i)"] = phase_family_parity(
        torch, SSM["hybrid"], hybrid.smoke())
    fam_walls["hybrid hd-112 parity (5i)"] = phase_family_parity(
        torch, SSM["hybrid"], dataclasses.replace(hybrid,
                                                  **SSM["hd112_cut"]))
    (fam_launches["ssm_train"], fam_keys["ssm_train"],
     fam_walls["ssm train (9f)"]) = phase_family_train(torch, SSM["arch"])
    (fam_launches["hybrid_serve"], fam_keys["hybrid_serve"],
     fam_serve["hybrid"], fam_walls["hybrid serve (9g)"]) = \
        phase_family_serve(torch, SSM["hybrid"])
    (fam_launches["hybrid_train"], fam_keys["hybrid_train"],
     fam_walls["hybrid train (9g)"]) = phase_family_train(
        torch, SSM["hybrid"], hybrid_train)
    # Zamba2-7B-Instruct whole at the zamba2-serve cell's shapes (9h)
    z_launches, z_shapes, z_errs, z_times, z_serve = phase_zamba2_serve(
        torch)
    z_errs.update(dec_errs)
    z_times.update(dec_times)
    fam_walls["zamba2 serve (9h)"] = z_serve["wall_s"]
    fam_keys = {entry: {name: {(name, *shape): n
                               for shape, n in by_shape.items()}
                        for name, by_shape in shapes_of.items() if by_shape}
                for entry, shapes_of in fam_keys.items()}
    for entry, keys in fam_keys.items():
        known = nf_errs if entry.endswith("serve") else checked
        unchecked = [k for ks in keys.values() for k in ks if k not in known]
        if unchecked:
            raise SystemExit(f"chip_smoke: the {entry} path ran shapes "
                             f"phase 3 did not check: {unchecked}")
    log("[main] the VLM, audio and SSM phases: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in fam_walls.items()))
    # the forward shapes of these serve paths and of the MoE, VLM and audio
    # training paths (their LiteModels') not timed above
    fwd_keys = [fam_keys[e] for e in ("vlm_serve", "audio_serve",
                                      "vlm_train", "audio_train",
                                      "hybrid_serve", "hybrid_train")]
    nf_times.update(phase_norm_flash_timing(
        torch, *[sorted({k[1:] for keys in fwd_keys + [moe_train_keys]
                         for k in keys.get(name, {}) if k not in nf_times})
                 for name in ("rmsnorm", "add_rmsnorm", "flash_attention")]))
    phase_fleet(torch)
    phase_train_parity(torch)
    phase_fleet_parity(torch)
    tr_times = phase_train_timing(
        torch, {name: [k[1:] for k in train_keys[name]]
                for name in ("rmsnorm_bwd", "add_rmsnorm_bwd",
                             "flash_attention_bwd")})
    kd_train = [k[1:] for k in train_keys["kd_loss_grad"]]
    tr_times.update(phase_grad_timing(torch, kd_train, iters=3))
    # the MoE training path's backward and kd_loss_grad shapes not timed
    # above (its LiteModel's are the llama's)
    tr_times.update(phase_train_timing(
        torch, {name: [k[1:] for k in moe_train_keys[name]
                       if k not in tr_times]
                for name in ("rmsnorm_bwd", "add_rmsnorm_bwd",
                             "flash_attention_bwd")}))
    tr_times.update(phase_grad_timing(
        torch, [k[1:] for k in moe_train_keys["kd_loss_grad"]
                if k not in tr_times], iters=3))
    # and the VLM's, the audio model's and the SSM family's
    fam_train = [fam_keys[e] for e in ("vlm_train", "audio_train",
                                       "ssm_train", "hybrid_train")]
    tr_times.update(phase_train_timing(
        torch, {name: sorted({k[1:] for keys in fam_train
                              for k in keys.get(name, {})
                              if k not in tr_times})
                for name in ("rmsnorm_bwd", "add_rmsnorm_bwd",
                             "flash_attention_bwd")}))
    tr_times.update(phase_grad_timing(
        torch, sorted({k[1:] for keys in fam_train
                       for k in keys.get("kd_loss_grad", {})
                       if k not in tr_times}),
        iters=3))

    weights = {(name, C * B, V, "float32"): n
               for name in ("kd_loss_fwd", "kd_loss_bwd")
               for (C, B, V), n in shapes.items()}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
         "replaces": "src/repro/kernels/kd_loss.py:30",
         "launches": launches[name],
         "max_abs_err": max(errs[s][i] for s in rows_main),
         **path_times(times, {k: n for k, n in weights.items()
                              if k[0] == name}),
         "shapes": [[C * B, V, n] for (C, B, V), n in sorted(shapes.items())],
         "dtype": "float32",
         "path": "core.distill.mutual_losses, off the HAPFL path (timed at "
                 "its row counts)",
         "vocab": [{"shape": [N, V, dtype],
                    **{k: times[(name, N, V, dtype)][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "share")}}
                   for N, V, dtype in VOCAB_SHAPES]}
        for i, name in enumerate(("kd_loss_fwd", "kd_loss_bwd"))]}
    record["kernels"].append({
        "name": "kd_loss_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
        "replaces": "src/repro/kernels/kd_loss.py:30",
        "launches": launches["kd_loss_grad"],
        "max_abs_err": max(grad_errs[s] for s in grad_main),
        **path_times(grad_times, {("kd_loss_grad", C, B, V, "float32"): n
                                  for (C, B, V), n in shapes.items()}),
        "shapes": [[C, B, V, n] for (C, B, V), n in sorted(shapes.items())],
        "dtype": "float32", "path": "HAPFL rounds",
        "sim": {"launches": sim_launches["kd_loss_grad"],
                "shapes": [[C, B, V, n]
                           for (C, B, V), n in sorted(sim_shapes.items())],
                "path": f"{ASYNC_WAVES} buffered waves, cross_size, "
                        f"topk+int8"}})
    for name, source, replaces in (
            ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:11"),
            ("add_rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:11"),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:23")):
        keys = serve_keys[name]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": serve_launches[name],
            "max_abs_err": max(nf_errs[k] for k in keys),
            **path_times(nf_times, keys),
            "shapes": [[*k[1:], n] for k, n in keys.items()],
            "dtype": "bfloat16", "path": "serve llama3.2-3b"})
    dec_keys = serve_keys["decode_attention"]
    record["kernels"].append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "none: the JAX package's decode attention is plain jnp",
        "launches": serve_launches["decode_attention"],
        "max_abs_err": max(dec_errs.values()),
        "shapes": [[*k[1:], n] for k, n in dec_keys.items()],
        "dtype": "bfloat16 and float32",
        "path": f"serve {SERVE['arch']} (max|err| against float64 over "
                f"phase 3c's shapes)",
        "cells": [{"shape": [*k[1:], DECODE_TIMED_VALID],
                   **{f: t[f] for f in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "warm_ms", "eager_ms")}}
                  for k, t in dec_times.items()]})
    for name, replaces in (
            ("rmsnorm_bwd", "src/repro/kernels/rmsnorm.py:11"),
            ("add_rmsnorm_bwd", "src/repro/kernels/rmsnorm.py:11"),
            ("flash_attention_bwd",
             "src/repro/kernels/flash_attention.py:23")):
        keys = train_keys[name]
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/rmsnorm.cu"
                       if "rmsnorm" in name else
                       "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": max(bwd_errs[k] for k in keys),
            **path_times(tr_times, keys),
            "shapes": [[*k[1:], n] for k, n in keys.items()],
            "dtype": "bfloat16",
            "path": f"train {TRAIN['arch']} (launches over "
                    f"{TRAIN['steps']} steps, shapes with their launches a "
                    f"step; the Pallas kernel has no backward)"})
    # the forward kernels and kd_loss_grad on the training path too
    for row in record["kernels"]:
        keys = train_keys.get(row["name"])
        if keys and row["name"] in ("rmsnorm", "add_rmsnorm",
                                    "flash_attention", "kd_loss_grad"):
            row["train"] = {
                "launches": train_launches[row["name"]],
                "shapes": [[*k[1:], n] for k, n in keys.items()]}
    # the restored params' forward (phase 9b), one of each
    for row in record["kernels"]:
        if ckpt_launches.get(row["name"]):
            row["checkpoint_forward"] = {
                "launches": ckpt_launches[row["name"]]}
    kd_key = ("kd_loss_grad", *kd_train[0])
    next(r for r in record["kernels"] if r["name"] == "kd_loss_grad")[
        "train"].update({k: tr_times[kd_key][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")})
    lse = {k[1:]: v for k, v in tr_times.items()
           if k[0] == "flash_attention_lse"}
    next(r for r in record["kernels"] if r["name"] == "flash_attention")[
        "train"]["lse_ms"] = [[*k, v["ms"], v["ms_without"]]
                              for k, v in lse.items()]
    # the MoE paths: serving (5c) and training (9c) launches and shapes,
    # with the times at their shapes (the forward kernels' at the serve
    # path's, which training shares but for its LiteModel's)
    # and the VLM and audio paths: serving (5e, 5f) and training (9d, 9e)
    per_step = (f"launches over {TRAIN['steps']} steps, shapes with their "
                f"launches a step")
    train_times = {**nf_times, **tr_times}
    paths = {"moe_serve": (f"serve {MOE['arch']} at full width and depth",
                           moe_serve_keys, moe_serve_launches, nf_times),
             "moe_train": (f"train {MOE['arch']} at full width, "
                           f"{MOE['train_layers']} layers ({per_step})",
                           moe_train_keys, moe_train_launches, train_times)}
    for arch in VLM_AUDIO["archs"] + (SSM["arch"],):
        fam = get_config(arch).family
        paths[f"{fam}_serve"] = (
            f"serve {arch} at full width and depth", fam_keys[f"{fam}_serve"],
            fam_launches[f"{fam}_serve"], nf_times)
        paths[f"{fam}_train"] = (
            f"train {arch} at full width and depth ({per_step})",
            fam_keys[f"{fam}_train"], fam_launches[f"{fam}_train"],
            train_times)
    paths["hybrid_serve"] = (
        f"serve {hybrid.name} at full width and depth",
        fam_keys["hybrid_serve"], fam_launches["hybrid_serve"], nf_times)
    paths["hybrid_train"] = (
        f"train {hybrid.name} at full width, {SSM['train_layers']} layers "
        f"({per_step})",
        fam_keys["hybrid_train"], fam_launches["hybrid_train"], train_times)
    # Zamba2-7B-Instruct's serve path (9h): its launches and shapes, the
    # kernels' errors there, and flash's times at its hd-224 prefill shape
    z_keys = {name: {(name, *shape): k for shape, k in by_shape.items()}
              for name, by_shape in z_shapes.items() if by_shape}
    for row in record["kernels"]:
        keys = z_keys.get(row["name"])
        if not keys:
            continue
        row["zamba2_serve"] = {
            "launches": z_launches[row["name"]],
            "shapes": [[*k[1:], m] for k, m in keys.items()],
            "max_abs_err": max(z_errs[k] for k in keys),
            "path": f"serve {ZAMBA2['arch']} whole, batch "
                    f"{ZAMBA2['batch']} x prompt {ZAMBA2['prompt']}, "
                    f"{ZAMBA2['n_new']} new tokens (zamba2-serve's shapes)"}
        if all(k in z_times for k in keys):
            row["zamba2_serve"].update(path_times(z_times, keys))
    for row in record["kernels"]:
        name = row["name"]
        for entry, (path, keys, counted, times_of) in paths.items():
            if name not in keys:
                continue
            row[entry] = {"launches": counted[name],
                          "shapes": [[*k[1:], n]
                                     for k, n in keys[name].items()],
                          "path": path}
            if all(k in times_of for k in keys[name]):
                row[entry].update(path_times(times_of, keys[name]))
    # the optimizer's kernels: phase 3b's cells (bitwise, device ms against
    # the byte bound; the norm's ms are sumsq and sumsq_finish together) and
    # the launches each training path above counted over its steps
    trained = {tag.replace(" ", "_"): path for tag, path in PATHS.items()
               if path["mode"] == "train"}
    for name, part in (("sumsq", "norm"), ("sumsq_finish", "norm"),
                       ("adamw", "update")):
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/adamw.cu",
            "replaces": "none: the JAX package's optimizer is plain jnp",
            "launches": train_launches[name],
            "dtype": "bfloat16 and float32 leaves",
            "path": f"train {TRAIN['arch']} (launches over "
                    f"{TRAIN['steps']} steps)",
            "cells": {cell: {"leaves": rec["leaves"], "params": rec["params"],
                             "bitwise": rec["bitwise"],
                             "launches": rec["launches"][name], **rec[part]}
                      for cell, rec in adamw.items()},
            **{tag: {"launches": path["launches"][name],
                     "steps": path["steps"], "leaves": path["leaves"],
                     "params": path["params"]}
               for tag, path in trained.items()}})
    log(f"[main] MoE serve (5c): prefill {moe_serve['prefill_ms']:.3f} ms, "
        f"decode {moe_serve['decode_ms']:.3f} ms a step graphed (bound "
        f"{moe_serve['decode_bound_ms']:.3f} ms), "
        f"{moe_serve['tokens_per_s']:.1f} tokens/s, peak "
        f"{moe_serve['peak_bytes']} B, dropped_frac "
        f"{moe_serve['dropped_frac']:.6f} a layer")
    for fam, m in fam_serve.items():
        log(f"[main] {fam} serve: prefill {m['prefill_ms']:.3f} ms, decode "
            f"{m['decode_ms']:.3f} ms a step graphed (replay "
            f"{m['replay_ms']:.3f} ms, loop {m['loop_ms']:.3f} ms, bound "
            f"{m['decode_bound_ms']:.3f} ms), "
            f"eager {m['eager_ms'][0]:.3f} / {m['eager_ms'][1]:.3f} ms, "
            f"{m['tokens_per_s']:.1f} tokens/s, peak {m['peak_bytes']} B"
            + (f"; the sLSTM blocks {100 * m['slstm']['share']:.1f}% of a "
               f"prefill" if "slstm" in m else ""))
    log(f"[main] zamba2 serve (9h, {ZAMBA2['arch']} at batch "
        f"{ZAMBA2['batch']}): prefill {z_serve['prefill_ms']:.3f} ms, decode "
        f"{z_serve['decode_ms']:.3f} ms a step graphed (replay "
        f"{z_serve['replay_ms']:.3f} ms, bound "
        f"{z_serve['decode_bound_ms']:.3f} ms), "
        f"{z_serve['tokens_per_s']:.1f} tokens/s, peak "
        f"{z_serve['peak_bytes']} B")
    # phase 13, the mesh-sharded path
    add_sharded_launches(record, phase_sharded(torch, card))
    # phase 14, the launch tooling
    phase_launch(torch, card)
    log(f"[main] chip_smoke wall {time.perf_counter() - t_script:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
