#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (diffnorm_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each printing one line with its time; any failure exits non-zero and
prints no result:

1. build: compile every kernel of the DDIM and S2ST paths from csrc/ with
   nvcc (one process per source, in parallel) and print the card's name and
   power limit.
2. kernels: each kernel's wrapper on the card at the path's shapes against its
   plain PyTorch version on the same inputs, with its median time, its bound
   on the card and the plain version's time: rms_norm_film, wavenet_chain,
   and the int8 fused_layer and ffpipe_layer (rows 1 and 2, which must agree
   bit for bit) at [64, 128, 512], P=1408, checked also at [4, 200],
   [1, 7] and [1, 6144], with one fused_layer call's device time per
   launch; flash_attention at the S2ST decoder's long-form shape (q
   [2,8,256,64] against k/v [2,8,2112,64]), at phase 15's (k/v
   [2,8,3072,64], keys 2112 and 120) and at B2 H8 T4096 D64, with
   ragged key masks, a fully masked row, odd Tq/Tk, Tk = 1, Tk = 65 and a
   short last key split (bf16 and float32), D 32/96/128 and float32, timed
   beside F.scaled_dot_product_attention with the same boolean key mask.
   Each also in float32 where it has a float32 kernel (rms_norm_film,
   wavenet_chain, flash_attention); wavenet_chain at the denoiser's 8
   dilations and the VAE's widths (timed, with one chain's device time per
   launch), at T=200 (two M tiles, the second ragged), at T=37 with every
   shifted tap dead, at C=200, and at phase 29's dummy_vae shapes (B8 x
   T400, C 256 and 768, d 1, 2, 4). masked_attention at 2048 keys for shapes
   the kernel does not take (bf16 D=80, float16) takes the module math and
   launches nothing.
2b. gradients: an MSE step of the denoiser's Wavenet (released width,
   B8 x T128) and of a FiLM RMSNorm with the kernels' forwards (their
   backward is the plain version's), in bf16 and float32, against the same
   step through the plain versions.
3. main path: ddim_sample at the released bf16 diff_discrete width (hidden
   512, latent 128, 768-d features, 12 + 4x8 denoiser, T=200, start step 50 =
   49 DDIM steps) from a seeded random init at B64 x T128, through the
   kernels, with the launch counts it implies; then the same run through the
   plain versions on the card as the reference.
3b. int8 main path: the same weights with quant_int8, on the routes
   fused_layer, ffpipe and ffpipe2 (each kernel launched 12 x 49 times),
   against the plain-version run (ffpipe2 against ffpipe, bit for bit).
3c. float32 main path: the same configuration in float32, 5 DDIM steps
   (stride 10), through the float32 kernels, against the plain-version run.
4. entry point: the weights written with weights.save_npz and the CLI run on
   8 synthetic utterances, in bf16 and with --quant-int8.
5. S2ST chain at CVSS length: s2st_generate with the released
   nar_s2ut_conformer (encoder 512 x 12, decoder 512 x 6, vocab 1004) and
   the released code-HiFi-GAN with its duration predictor, seeded random
   init (the specials' output columns zeroed), bf16, at bench.py --e2e's
   shape: B16 x 480 fbank frames, 15 iterations, max_len 256, max_duration
   4, a 384-unit wav canvas, vocoder chunk 4. The subsampled source (120
   frames) is too short for flash_attention, which launches 0 times here.
   The wall is the median of 3 runs after a warm-up. Then the same run
   through the plain versions: units equal, waveform row-cos held to a
   bound.
6. S2ST chain, long form: B2 x 8448 frames (84.5 s, 2112 subsampled
   frames), the same models: every decoder forward's 6 encoder attentions
   launch flash_attention. Against the plain-version run: a share of equal
   units, the waveform's row-cos, and one teacher-forced decoder forward's
   logits (row-cos, argmax agreement).
7. entry point: both models written with weights.save_npz and cli.s2st run
   on 8 synthetic .npy utterances with --dur-prediction.

Phase 3d (after 3c), main path int8 static: JAX's DDIM serving headline
(bench.py:38-49), the int8 module route with per-tensor weight and
activation scales, int8 WaveNet convs and static activation scales
calibrated on the batch (start step 50, 6 points), 49 steps at B64 x T128,
with its site count, RTF and profile, against the same route through the
plain versions (recon row-cos, unit agreement) and the bf16 path's units.

8. train: bf16 training updates at the released widths, B64 x T128, float32
   masters, the recipes' optimizer and schedule: the normalizer over a
   frozen VAE (update_freq 2, 3 updates), then the VAE (2 updates), each
   through the kernels' forwards and through the plain versions from one
   initialization on the same injected draws (loss and gradient norm per
   update held to bounds), the frozen VAE bit for bit, one update at
   dropout 0.1; ms per update, launches per update, peak memory, profile.
9. entry point train: cli.train on a small corpus at the released widths in
   bf16, the depth cut (CLI_NORMALIZER: one WaveNet stack, two denoiser
   layers, one VAE decoder layer): the VAE (2 updates, checkpoint), the normalizer over it (2 updates,
   checkpoint, resumed to 4), then cli.diff_norm_synthesis --params-npz on
   the trained normalizer.
10. train NAR: the released nar_s2ut_conformer (encoder 512 x 12, decoder
   512 x 6, vocab 1004) from a seeded random init, bf16 forward, float32
   masters, scripts/s2ut_train.sh's optimizer (Adam (0.9, 0.98), lr 5e-4,
   inverse_sqrt warmup from 1e-7, clip 10, label smoothing 0.2, dropout
   0.1). CVSS-shaped: B64 sorted ragged sources of 300-625 fbank frames
   (--max-tokens 40000) with 100-250 units + EOS on a random-mask canvas,
   3 updates and one at --cg-prob 0.15: ms per update, peak memory, the
   profile, flash_attention launches (0). Long form: B2 x 8448 frames (S =
   2112, the last row half length), 600 and 300 units, --attention-dropout
   0: one update through the kernels and one through the plain versions
   from one init on the same generators, each after a warm-up validation
   forward (loss, gradient norm held to bounds; the decoder's 6 encoder
   attentions launch flash_attention), then a valid_step the same two ways.
11. entry point train NAR: 24 synthetic 16 kHz WAV utterances of 3-7 s
   (written with `wave`, through the fbank front end), 40-200 unit targets,
   config.yaml with utterance CMVN and SpecAugment on _train; cli.train at
   the released widths in bf16 for 2 updates and a checkpoint, resumed to
   4, then cli.s2st --params-npz on the step directory with the released
   vocoder: its wall and RTF.
12. prep bench: bench.py --prepare's program in eager form, mHuBERT-base
   (768 x 12 heads, FFN 3072, the released conv extractor) from a seeded
   init to layer 11 in bf16 on B8 x 10 s, then the K=1000 argmin on float32
   features: the median wall of 5 calls, RTF, peak memory, profile; bf16
   against the float32 forward (features row-cos and max-abs/scale held to
   bounds, units under a fitted codebook).
13. prep long form: one 70 s utterance (3499 frames) in float32, the CLI's
   type: every layer's self-attention launches flash_attention (11 a
   forward), held to the same forward through the plain versions (features,
   units under a fitted K=1000 codebook).
14. entry point prep: cli.get_manifest on 24 WAV utterances of 3-7 s and a
   70 s one, then cli.prepare dump-features (the encoder from a
   weights.save_npz file), learn-kmeans (K=1000) and quantize; each wall,
   and every file checked (feature shapes from frames_for_samples, the
   manifests, unit ids in [0, 1000)).
Phase 2 also holds flash_attention's float32 kernel (three tf32 passes on
the tensor cores) at the shapes float32 callers send: HuBERT's long form
[1, 12, 3499, 64] and cli.prepare's longest chunk [1, 12, 4999, 64], no
mask, and the S2ST decoder's shape with its key mask, each timed beside the
plain version and SDPA in float32 with both bounds (SIMT float32, three
tf32 passes); and at D 80 and 128 with ragged keys and a fully masked row.
15. eval (scripts/s2ut_eval.sh): a seeded corpus of 16 CVSS-length .npy
   sources (480 frames) and one of 8448, the released NAR and vocoder via
   weights.save_npz and a seeded wav2vec2-large-lv60-shaped CTC checkpoint
   written in Hugging Face's layout; cli.generate (--max-tokens 20000, 15
   iterations; the long source's batch launches flash_attention), again with
   --init-unit-file and with --cond-scale 2, eval.unit_bleu,
   cli.generate_waveform --dur-prediction and eval.asr_bleu, each command's
   wall; cli.generate's units against an in-process mask_predict_decode
   (equal), the forced canvases' lengths, one wav per unit line, and the
   ASR's logits on the card against its CPU float32 forward. A fourth
   cli.generate run with --quant-int8 --quant-int8-static: its calibration
   log line, its H- units against an in-process int8-static decode
   calibrated on the same first batch (equal), its flash_attention launches.
16. (run after 7, beside the bf16 chain of phase 5) S2ST int8 static,
   bench.py --e2e's default: the released NAR with quant_int8 from phase
   5's seeded init, its 156 activation sites calibrated on the first batch's
   canvas, the vocoder in bf16; phase 5's run and checks at B16 x 480 (wall,
   RTF, profile), its reduced units against the bf16 decode's and one
   teacher-forced decoder forward against bf16's logits; then the long form
   (B2 x 8448) as phase 6 runs it, flash_attention against the plain
   versions.
17. recipe stage 6, the code-HiFi-GAN fine-tune: the released generator with
   its duration predictor, full-width MPD (periods 2-11) and MSD (3 scales),
   JAX's defaults, at scripts/full_recipe.sh's B32 x 28 units: ms per update,
   peak memory and profile in float32 with TF32 on for the cuDNN convs
   (torch's default, the CLI's), with TF32 off, and with --bf16-disc; one
   update on the card against the CPU float32 update. Then cli.train_vocoder
   on 24 WAVs of 3-7 s (10 updates, a save at 10, resumed to 20) and
   cli.generate_waveform --dur-prediction from the step-20 directory on
   phase 15's hyp.unit, each wall.
18. checkpoints in: seeded fairseq state dicts at the released widths (the
   normalizer's and the NAR's depth cut: CLI_NORMALIZER, CLI_NAR_DEPTH) in
   fairseq's released envelope (cfg, model, optimizer history, extra state,
   the last optimizer state), written as .pt: the diff_discrete normalizer
   of phase 3 (denoiser and frozen VAE), the nar_s2ut_conformer of phase 5,
   full-width MPD and MSD; cli.convert_checkpoint on each (its balanced key
   inventory, the .pt size and the wall). cli.diff_norm_synthesis --ckpt on
   the converted normalizer over 64 utterances x 128 frames of 768-d
   features: its manifest equal line for line to an in-process ddim_sample
   of the same .pt (convert_diffusion_state + from_jax_variables, the CLI's
   draw_noise), its rms_norm_film and wavenet_chain launches, recon against
   the plain versions (PATH_ROW_COS). cli.generate --path on the converted
   NAR over phase 15's corpus: H- units equal an in-process decode, its
   flash_attention launches; cli.validate --path against an in-process
   criterion forward (VALID_REL). cli.average_checkpoints over it and a
   second seeded NAR (every leaf the mean within 1e-6), then cli.train
   --restore-file <average> --reset-optimizer for 2 updates on phase 11's
   corpus: its first loss against an in-process update from the mean
   (WARM_LOSS_REL). Each command's wall.
19. the NAR model's options: the released nar_s2ut_conformer from a seeded
   init with n_frames_per_step 2, 256-d target-speaker embeddings, the
   three aux tasks of fairseq's direct_s2st_discrete_units.md
   (source_letter and target_letter transformer heads on encoder layers 6
   and 8, decoder_target_ctc on decoder layer 3; seeded letter
   dictionaries and targets, the heads' dropout 0) and a CTC head with an
   injected ctc_target. One training update at phase 10's CVSS shape (the
   second update timed, the third profiled) and one in long form (B2 x
   8448), each through the kernels and through the plain versions from one
   init with attention dropout 0: loss, gradient norm and every aux term
   held to phase 10's bounds; flash_attention 10 launches a long-form
   forward (6 in the decoder, 4 in the aux heads' cross-attention),
   training and validation. mask_predict_decode of the stacked,
   speaker-conditioned model at B16 x 480 (units equal to the plain run)
   and B2 x 8448 (LONG_UNIT_AGREE); s2st_generate with the released vocoder
   made multi-speaker, one speaker per row (wall, RTF); cli.train for 2
   updates with every option's flag on phase 11's corpus plus speakers and
   letter targets, then cli.generate on its step directory (H- units equal
   an in-process decode).
20. the S2ST options left out until then, at the released widths: a
   2-member ensemble of seeded NARs (mask_predict_decode over a list) at
   B16 x 480 and B2 x 8448, against one member's wall, through the plain
   versions (units equal at CVSS length, LONG_UNIT_AGREE in long form;
   flash_attention 12 launches a long-form forward) and chunked with the
   history (--decode-chunk 4 / 1: the last step is the canvas, a share of
   units equal to the unchunked decode); cli.generate --path a:b
   --retain-iter-history --decode-chunk 4 on phase 15's corpus, its H- and
   E- lines equal to an in-process decode. encoder_remat: one long-form
   NAR update with dropout without and with remat (ms, peak memory, loss
   and gnorm, BatchNorm statistics and generator states equal). The
   augments: cli.train (NAR) with concataugment and SpecAugment, and
   cli.train_vocoder --data-config with noise, babble, sporadic noise and
   noisy overlap at B32 x 28 units, 2 updates each (ms per update, the
   transforms' share of host time). repr_to_speech: cli.prepare
   dump-features, then cli.train_vocoder --input-type features at B32 x 32
   frames of 768-d features (ms, peak, profile).
21. the training remainder: (a) the prompt-conditioned normalizer
   (use_cond: the PerceiverResampler, depth 2, 64 latents over 768-d
   prompts, cross-attention in all 12 layers, FiLM condition 4096) at the
   released widths, B64 x T128 with 160-frame prompts: 3 bf16 updates
   through the kernels and through the plain versions from one init on the
   same injected draws and drop mask at dropout 0 (loss and gradient norm
   per update held to phase 8's bounds), ms and launches per update (at
   least a forward's rms_norm_film and wavenet_chain sites), peak memory,
   profile; forward_with_cond_scale at 1 (equal to the conditioned
   forward) and 2 against the plain versions; one update and one guided
   forward at a 1984-frame prompt with their flash_attention launches.
   (b) cli.train in bf16 for 2 updates each: speech_diffusion (diff_latent),
   speech_diffusion_hubert (diff_hubert), hubert_vae, and
   speech_diffusion_discrete --arch diffusion_transformer; walls, ms per
   update, launches. (c) cli.train --optimizer adamax --lr-scheduler cosine
   --ema-decay 0.999 on the normalizer (CLI_NORMALIZER's depth), 3 updates then
   --restore-file 2 more, equal bit for bit to a 5-update run; every other
   optimizer under a schedule (manual and reduce_lr_on_plateau among them)
   on the card against the CPU: one float32 Trainer update of a small
   normalizer, and 2 steps of the optimizer alone on seeded gradients.
22. the recipe's last training options: (a) cli.train (the NAR at the
   released widths, two encoder and two decoder layers, bf16) on phase 11's
   corpus in two shard directories (--data a:b), 2
   epochs, with --num-workers 4 (a checkpoint at update 2, mid-epoch) and
   0: the same batch lists, each epoch's those of the iterator on its
   shard, the same losses; a --restore-file resume from the mid-epoch
   checkpoint starts at the first untrained batch with the same losses; ms
   per update and the host share of the loop. (b) cli.train_vocoder at
   B32 x 28 units on 96 WAVs with --num-workers 0 and 4. (c)
   cli.diff_norm_synthesis (CLI_NORMALIZER's depth) with its file prefetch on
   32 utterances in
   chunks of 8, row for row against a sequential in-process ddim_sample.
   (d) --quant-int8 training on the int8 module route: a released-width
   normalizer update (B64 x T128; its bf16 gradient against the float32
   recompute) and a long-form NAR update (6 flash_attention launches). (e)
   the int8 vocoder, dynamic and static, at S2ST's decode canvas against
   the float vocoder (JAX's bounds), then cli.s2st --int8-vocoder static.
   (f) a normalizer step directory (CLI_NORMALIZER's depth) with a seeded
   Adam state in the bridge's format; cli.train --restore-file for 1 update against an
   in-process Trainer loaded with the same state.
23. the AR S2UT family: fairseq's s2ut_conformer at its released widths
   (encoder 512 x 12, causal decoder 512 x 6, vocab 1004), seeded, bf16.
   (a) the beam decode (beam 5, max_len 256, through the KV cache) at B16 x
   480: wall (one run after a warm-up cut to 8 steps), steps, device kernels
   a step and busy share (a 40-step decode's profile less an 8-step one's);
   the cached decode against the full teacher-forced forward on the best
   hypotheses (logits row-cos). (b) the same in long form, B2 x 8448: 6
   flash_attention launches a step (one query a row), held against the same
   decode through the plain versions (a share of equal units; the
   teacher-forced logits on the kernel path's hypotheses by row-cos). (c)
   s2ut_transformer's long-form teacher-forced forward: the encoder's 12
   self-attentions and the decoder's 6 encoder attentions through the
   kernel, against the plain versions. (d) one AR update with
   label_smoothed_cross_entropy and one with speech_to_unit and an aux head
   at phase 10's --max-tokens 40000 batch (ms, peak, busy); cli.train --task
   speech_to_speech_ar on phase 11's corpus, then cli.generate with beam 5,
   --sampling, --score-reference, --n-frames-per-step 2 (a seeded stacked
   model), the AR decodes cut to CLI_MAX_LEN steps, and the NAR decode with
   --rerank-path, each one's units against an in-process decode.
24. the two-pass S2ST families and the spectrogram decoders at their
   published widths, seeded, bf16: UnitY (unity_conformer, encoder 256 x
   16, decoders 256 wide with 8 heads, the first pass 4 layers over 28
   letters, 2 synthesizer layers, vocab 1004), s2spect_conformer (that
   encoder, the mel decoder 512 x 6 with 4 heads, 80 bins) and
   Translatotron2 (s2spect2_conformer). (a-c) each family's decode as
   cli.generate runs it (beam 5 in every beam pass, the first pass to 200
   tokens, units to 256, the mel rollout's 256 steps, the prenet's dropout
   from a seeded generator) at B16 x 480 and B2 x 8448: wall (one run after
   a warm-up cut to 8 steps a pass), steps, the cached steps against the teacher-forced forward (row-cos), and in long
   form a step alone of the pass that reaches the kernel (an 8- and a
   40-step decode's profiles less each other), flash_attention's launches
   (4 a first-pass step and 4 for the handoff; 6 a mel step) and the decode
   through the plain versions (first-pass tokens and units to phase 23's
   share, teacher-forced logits or frames to its row-cos, mels over the
   valid frames and over all 256 rollout frames to a mean row-cos).
   (d) one update of each family at phase 10's --max-tokens 40000 batch (ms,
   peak, busy). (e) cli.train --task speech_to_speech for UnitY and
   Translatotron2 on phase 11's corpus with letter and seeded mel targets,
   then cli.generate for both and a seeded s2spect_conformer, the decodes
   cut to CLI_MAX_LEN_MT first-pass tokens and CLI_MAX_LEN units or frames:
   H- units and .npy frames against in-process decodes, the mel vocoder's
   WAVs.
25. text-input TTS and the S2T model at their published widths, seeded:
   (a) the tts_transformer_base rollout (ar_speech_generate over the text
   encoder, B8 rows of 90-160 phones, 256 steps, bf16): wall, lengths, no
   flash_attention launch, the cached steps against the teacher-forced
   decoder. (b) fastspeech2_base, its duration head set to 12 frames a token
   (1080-1920 valid frames of the 2048-frame buffer a row): generation
   (NonARSpeechGenerator) and validation (fastspeech2_loss on gold
   durations) in float32 and bf16, each forward's 4 decoder self-attentions
   through the kernel ([8, 2, 2048, 128] with the frame mask), against the
   same runs through the plain versions (frames by row-cos over the valid
   ones, losses by relative difference). (c) s2t_transformer's beam decode
   (beam 5, 256 steps, vocab 8004) at B16 x 480 and B2 x 8448: 12 encoder
   self-attentions and 6 encoder attentions a step (D = 64) through the
   kernel in long form; s2t_conformer's in long form (6 a step, D = 32);
   each long form against the plain versions (phase 23's bounds). (d) one update
   of each model (ms, peak, busy). (e) cli.train -> cli.validate ->
   cli.generate for the tts_transformer, FastSpeech2 and s2t_transformer,
   each against its in-process run.
26. text machine translation at the published widths, seeded, bf16, over
   32768-token source and target tables: (a) transformer_wmt_en_de_big's
   beam decode (beam 4, lenpen 0.6, 200 steps) over B64 newstest-length
   sentences (10-100 tokens; no flash_attention launch) and B2 x 2112 tokens
   (the second row 1056): its 6 encoder self-attentions ([2,16,2112,64]) and
   6 encoder attentions a step (q [8,16,1,64]) through the kernel; the cached
   steps against the full forward; the long form against the plain versions
   (tokens, teacher-forced logits). (b) cmlm_transformer's mask-predict (10
   iterations, length beam 5, 256-token canvases, every fill run) and (c)
   levenshtein_transformer's decode (9 iterations, eos penalty 0) at the
   same shapes, 6 launches in the encoder and 6 a decoder pass in long form,
   each held to the plain versions (tokens, the decoder's logits). (d) one
   update of each at --max-tokens 4096 (ms, peak, busy). (e) cli.preprocess
   -> cli.train (2 updates, 2 + 2 layers) -> cli.generate -> cli.interactive
   -> cli.score for each on a seeded bitext, the H- lines against the
   in-process decodes and the BLEU against cli.generate's.
27. SEDD, the unit LM, IDDPM and MoE, seeded: (a) sedd_absorb (512 x 8, 8
   heads, 1004 units + MASK) in bf16 and float32, the arch's type: its
   FiLM norms at [16,1024,512] and [2,2112,512] and its self-attention at
   [2,8,2112,64] (the second row's keys 1056) held to the plain versions;
   sedd_sample (64 steps) at B16 x 1024 (the --tokens-per-sample block: 16
   rms_norm_film launches a score call, no flash_attention) and at B2 x
   2112, the second row 1056 valid (8 flash_attention launches a score
   call too), and sedd_refine (16 steps) there on a canvas 30% <unk>; each
   score forward and one sampler update on shared uniforms against the
   plain versions, every MASK resolved, the refinement changing only the
   masked positions. (b) one sedd_loss update at B8 x 1024 (bf16 forward,
   float32 masters). (c) transformer_lm (512 x 6, FF 2048): cli.eval_lm's
   NLL over B16 x 1024 blocks and one update; its causal attention reaches
   no kernel. (d) IDDPM: create_diffusion(learn_sigma=False,
   timestep_respacing="ddim25") over the released normalizer's Denoiser
   (latent 128, B64 x T128, bf16) as the denoise_fn: ddim_sample_loop
   against the plain versions on the same noises, with each kernel alone
   through its plain version too, and one training_losses update; one
   Denoiser call at the loop's first step against the float32 plain call,
   the kernels' bf16 error beside the plain versions', and at its last
   step against the plain versions; in float32 the first call against the
   plain versions and the sample against a float64 run, its error beside
   the plain versions'. (e) BaseLayer (512, FF 2048, 8 experts, 16384
   tokens, bf16) forward, sinkhorn_routing on the card against the CPU on
   the same scores, balanced_assignment_host on the host. (f) cli.train
   --task sedd_lm (2 updates, 2 layers) -> cli.validate, and cli.train
   --task language_modeling (2 updates, 2 layers) -> cli.eval_lm, its
   perplexity against the in-process evaluation.
28. wav2vec2 and HuBERT pretraining and the CTC fine-tune at base width
   (768 x 12, FFN 3072, the released conv extractor), seeded, float32: (a)
   hubert_base (K = 504, the recipe's dropouts, LayerDrop 0.05,
   feature_grad_mult 0.1): one update at B4 x 250,000 samples (780 frames;
   ms, peak, busy, the host's mask draw), then a validation forward at B2 x
   720,000 / 512,000 samples (2249 / 1599 frames) through the kernels (12
   flash_attention_f32 launches) and the plain versions: logits row-cos and
   the loss. (b) wav2vec2_base (100 negatives, loss weights [0.1, 10]): the
   same, on the contrastive logits' finite entries (the removed negatives
   at the same places). (c) hubert_ctc at base width: one fine-tune update
   with the time and channel masks, feature_grad_mult 0 and
   freeze_finetune_updates 1, then the long-form greedy CTC decode in
   float32 and bf16 against the plain versions (frame tokens, logits
   row-cos; 12 launches a forward). (d) at 2 layers: cli.train
   hubert_pretraining and audio_pretraining on written manifests, labels
   and dict.km.txt, cli.train audio_finetuning --w2v-path on the HuBERT step
   directory with use_audio_input -> cli.validate -> cli.generate, its D-
   lines against the in-process greedy decode; cli.convert_checkpoint
   --type hubert_ctc on a seeded fairseq state dict, loaded into the model.
Phase 2 times flash_attention also at phase 23's decode step (q
[10,8,1,64] against k/v [10,8,2112,64], beams of the half-length row
masked at 1056 keys), its S2T encoder's self-attention ([2,8,2112,64]),
phase 24's decode steps (UnitY's q [10,8,1,32], Translatotron2's
[10,4,1,128], s2spect's [2,4,1,128], against 2112 keys) and phase 25's
FastSpeech2 decoder ([8,2,2048,128] in bf16 and float32) and phase 26's
text MT shapes (the big transformer's encoder [2,16,2112,64] and decode step
q [8,16,1,64], the CMLM decoder's q [10,8,256,64]) beside SDPA and its
bound.
The kernels JSON line reports the float32 kernel as flash_attention_f32
(its launches those of phase 13) beside the bf16 one (phase 6's, phase
16's long form, the four cli.generate runs of phase 15, phase 18's,
phase 19's and phase 20's);
rms_norm_film and wavenet_chain count phase 3's run, phase 18's CLI run and
phase 21's kernel runs (21a's updates and guided forwards, 21b's CLI runs)
and phase 22's (22c's CLI run, 22d's updates, 22f's CLI update), where
flash_attention counts 21a's long-prompt runs, 22d's long-form update,
phase 23's long-form beam decode and s2ut_transformer forward, phase
24's long-form decodes and phase 25's bf16 FastSpeech2 runs (in process
and its CLIs) and long-form S2T decode and phase 26's long-form text MT
decodes too; flash_attention_f32 phase 25's
float32 FastSpeech2 generation and validation beside phase 13's. Phase 27
adds its counted SEDD runs to rms_norm_film, flash_attention (bf16) and
flash_attention_f32 (float32), and its IDDPM sample to rms_norm_film and
wavenet_chain. Phase 2 also times flash_attention at SEDD's long form
([2,8,2112,64], keys 2112 and 1056) in bf16 and float32. Phase 28 adds its
long-form forwards' launches to flash_attention_f32 (float32) and
flash_attention (the bf16 CTC decode); phase 2 times the kernel at its
encoder's [2,12,2249,64], keys 2249 and 1599, in both types.

29. TranSpeech's baseline normalization and the runtime remainder: (a)
   cli.speech_norm on two splits of 32 seeded synthetic voices (2-8 s at 16
   kHz, f0 90-240 Hz, vibrato, noise, silence at both ends; YIN on the
   card), each of its three passes timed, YIN's time a second of audio and
   its medians against the f0 that made each voice, then the CLI on two of
   them on the card and with --cpu (medians within 1e-4 relative, wavs
   within SN_WAV_ATOL); (b) lightconv and dynamicconv at [8, 1024, 512], H
   8, K 31 (lightconv_iwslt_de_en's widest layer), causal and same, float32
   and bf16, against their float64 definition, timed; (c)
   expected_alignment_from_p_choose at [64, 128, 512] float32 with a
   padding mask against the host twin, timed; (d) cli.train without data
   on disk, 2 updates each in bf16 at the archs' widths, the depth cut to 2
   layers where checkpoints are written: dummy_vae (768-d features, latent
   128, B8 x 400 frames), dummy_nar (B8 x 480 fbank frames), dummy_ar and
   dummy_mt at their defaults, cli.hydra_train on dummy_vae with dotted
   overrides, a --user-dir plugin's task from a --config YAML, then
   cli.interactive on the dummy_nar checkpoint with two .npy lines; (e) the
   wavenet_chain launches of the VAE runs' encoder are added to that
   kernel's row.
30. Data parallelism (parallel/, the trainer's --zero-sharding os and
   --fsdp). The card holds one H100 and NCCL takes one rank a device, so two
   ranks share cuda:0 over gloo (the port stages each collective on CUDA
   tensors through host memory under gloo), started once as processes of
   this script (dp_worker); rank 0 also makes the one-process runs. Each
   against the one-process run at the released widths: (a) DDIM B64 x
   T128, 49 steps, bf16, one block of rows a rank: units equal, both timed;
   (b) two float32 normalizer updates (dropout 0, sgd with momentum, the
   trainer's own draws) on B33 x T128 split 17 + 16, replicated,
   --zero-sharding os and --fsdp: the first loss within DP_LOSS_REL and the
   masters' update within DP_UPDATE_REL, each rank's ms and peak memory;
   (c) the long-form S2ST decode (B2 x 8448) in float32, a row a rank (in
   bf16 the random decoder's near-ties part the units of any two batch
   shapes): units equal, waveform within LONG_WAV_ROW_COS,
   flash_attention_f32 counted; (d) cli.train of the normalizer at
   CLI_NORMALIZER's depth at 2 ranks with --fsdp --zero-sharding os in
   bf16, then cli.validate at one rank on its checkpoint against the run's
   own validation loss; (e) cli.diff_norm_synthesis --data-parallel 2 on
   it: test.tsv byte for byte the one-process run's. Before the ranks, a
   process group of one rank over NCCL in this process runs the same code
   (a DDIM and an update at CLI_NORMALIZER's depth against the run without
   a group). Only world sizes 1 (NCCL) and 2 (gloo, one device) run here.
31. The model axis (parallel/sharding_rules.shard_model, parallel/
   sequence.py, parallel/pipeline.py, cli.train's --model-parallel,
   --profile and --heartbeat-timeout). Two gloo ranks share cuda:0 again
   (mp_worker), a model group of 2 (or a seq / stage axis of 2); rank 0
   also makes the one-process runs. (a) two float32 updates of the
   released normalizer (sgd with momentum) on B16 x T128 at tensor
   parallel 2 against one process: the first loss within MP_LOSS_REL, the
   masters' update within MP_UPDATE_REL; (b) the long-form mask-predict
   decode (B2 x 8448 fbank frames) in float32 with the NAR model split over
   the 2 ranks (4 of its 8 heads a rank): tokens equal to one process,
   scores within MP_SCORE_ATOL, flash_attention_f32 launched on each rank;
   (c) conformer_encode_sp of the NAR's encoder over 2 ranks on the same
   batch against the unsharded encoder (valid frames, row-cos
   MP_ROW_COS); (d) pipeline_apply of the normalizer transformer's 12
   layers as 2 stages of 6 on 4 microbatches of B16 x T128 against the 12
   layers in one process (row-cos MP_ROW_COS); (e) cli.train of the
   normalizer at CLI_NORMALIZER's depth with --model-parallel 2 --profile
   --heartbeat-timeout 600, its trace file, then cli.validate at one rank
   on its checkpoint against the run's own validation loss. Each prints its
   wall and each rank's peak memory against the one-process run; then
   rms_norm_film, wavenet_chain and flash_attention_f32 are held to their
   plain versions at the shapes a rank ran.
32. Serialized export, the compile cache and HuBERT-CTC: the DDIM denoiser
   call (LatentDiffusionModule.denoise at B64 x T128, the released widths,
   bf16 and int8 route fused_layer) exported by utils.export with its
   parameters baked and a symbolic batch, and the long-form NAR forward
   (B2 x 8448) with its parameters as input; a fresh process that imports
   utils.export and no model code finds every kernel library built, loads
   each artifact and runs it at B64 and B16 (the NAR with the state dict)
   against the eager outputs, counting each kernel's launches; a seeded
   HuBERT-CTC checkpoint at hubert-large-ls960-ft's widths through
   load_ctc_checkpoint on 45 s of audio (flash_attention in float32),
   against the plain versions; and, beside them, a process under
   DIFFNORM_COMPILE_CACHE that builds rms_norm_film there and loads it
   from there.
Then one JSON line of per-kernel numbers and, last, {"ok": true, "device": ...}.
Exits non-zero without CUDA, and in a directory without the port.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import logging
import math
import statistics
import subprocess
import re
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM
L2_BYTES = 50 * 2 ** 20      # H100 SXM
BF16_FLOP_PER_S = 989e12     # dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12     # dense int8 tensor cores
F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores
TF32_FLOP_PER_S = 494.7e12   # dense tf32 tensor cores
B, T, START_STEP = 64, 128, 50
# more kernel-check shapes: at T=200 sequences straddle the int8 GEMMs'
# 128-token tiles and the attention's 64-key blocks, and the last tile is
# partial (B even, so ffpipe rows 2 applies); [1, 7] is one short sequence
# (the conv's shifted tiles mostly out of bounds, rows 2 falls back to 1);
# [1, 6144] the CLI's largest length bucket
EDGE_SHAPES = ((4, 200), (1, 7), (1, 6144))
C, INNER, HEADS, DIM_HEAD = 512, 1365, 8, 64  # the released denoiser transformer
SECONDS_PER_UNIT = 0.02      # 50 Hz units

# rms_norm_film: kernel and plain version do the same f32 math on the same
# bf16 inputs and round once, so they may differ by one bf16 ulp (rsqrt and
# summation order), plus the f32 rounding of a cancelling sum (see
# check_rms_norm_film). wavenet_chain: sums of up to 13 * C products in another
# order, rounded to bf16 after every stack; per-row direction and the worst
# error against the output's scale.
CHAIN_ROW_COS, CHAIN_REL_ERR = 0.999, 2e-2
# float32 chains: the same f32 products summed in another order, no rounding
# between stacks
CHAIN_F32_REL_ERR = 1e-5
# the full 49-step path, kernels against plain versions: bf16 rounding
# differences compound over the steps
PATH_ROW_COS = 0.99
# ffpipe_layer: the kernel repeats the plain version's arithmetic (exact int32
# sums, every epilogue operation rounded alone), but the norm's sum of squares
# reduces in another order. That moves an int8 code across a rounding
# boundary now and then, and the flip reaches the output: on the CPU, the
# plain version with only that sum taken in another order agrees with itself
# at min row-cos 0.99998, max-abs/scale 6.6e-3 (one bf16 ulp at the top of
# the output's range) and 99.89% bit-equal outputs at this shape.
# fused_layer: its attention half also sums the q/kv/o products and the
# softmax denominator in other orders, so more codes flip; held to the
# bounds the CPU tests hold its plain version to against the JAX kernel.
FF_ROW_COS, FF_REL_ERR, FF_BIT_EQUAL = 0.9995, 2e-2, 0.98
LAYER_ROW_COS, LAYER_REL_ERR = 0.9995, 3e-2
# flash_attention: the tolerance of tests/test_pallas_ops.py:25 plus one ulp
# of the output's type (kernel and plain version each round once)
FLASH_RTOL, FLASH_ATOL = 2e-3, 2e-4
# gradients on the card: a training forward through the kernels (their
# backward is the plain version's) against the same step through the plain
# versions, with an MSE loss, so the kernels' forward values reach the
# gradients. bf16 forwards differ by an ulp here and there: each gradient
# row's direction; float32 forwards by sum order: the worst error against
# the gradient's scale
GRAD_B, GRAD_ROW_COS, GRAD_F32_REL = 8, 0.999, 1e-4
# float32 ddim_sample through the kernels against the plain-version run: f32
# products in other orders, over 5 DDIM steps (stride 10) and the decode
F32_STRIDE, F32_PATH_ROW_COS, F32_PATH_REL = 10, 0.9999, 1e-3
# the int8 static route (JAX's serving headline): calibration points, and the
# unit agreement of tests/test_variants.py:227-228, held against the same
# route through the plain versions and against the bf16 kernel path
STATIC_POINTS, STATIC_UNIT_AGREE = 6, 0.95
# bf16 training updates through the kernels (forward) against the plain
# versions: per update, the loss and the gradient norm. On an H100 the
# normalizer gave 6.3e-5 and 4.5e-3, the VAE 3.6e-5 and 5.5e-5; the bounds
# were 1e-2 and 2e-2 for that first run
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-3, 1e-2
# NAR training (phase 10): scripts/s2ut_train.sh's batch cap and optimizer;
# the CVSS-shaped batch's longest source is the cap over the batch size
NAR_B, NAR_MAX_TOKENS, NAR_UPDATES = 64, 40000, 3
NAR_TRAIN = dict(lr=5e-4, warmup_updates=10000, warmup_init_lr=1e-7, adam_betas=(0.9, 0.98),
                 clip_norm=10.0, dtype="bfloat16", seed=42)

# the training remainder (phase 21): the prompt-conditioned normalizer at the
# released widths (FiLM condition 4096) at phase 8's B x T with a 160-frame
# prompt, then one update and a guided forward at a 1984-frame prompt, whose
# 64 latents + 1984 frames are flash_attention's 2048 keys; a single bf16
# denoiser forward through the kernels against the plain versions by row
# cosine; cli.train's optimizer run (adamax, cosine, EMA) at one batch per
# epoch (24 utterances under --max-tokens 4096), 3 + 2 updates against 5;
# every other optimizer with a schedule on the card against the CPU, as the
# norm of the difference over the norm of the change. One float32 Trainer
# update of a small no-VAE normalizer: its gradients agree within ~1e-4 per
# tensor on an H100 (float32 reductions in another order), but a sign-like
# first step (adam, adafactor: u ~ g / |g|) flips the elements near zero
# (the first runs on an H100: up to 2.5e-2 of the update, against a first bound of
# 1e-3). 2 steps of the optimizer alone on the same seeded gradients,
# unclipped: float32 rounding, up to 8.9e-6, but adafactor's block-RMS clip
# sits at its kink on a first step (rms(u) ~ 1, the threshold), where a
# mean of squares summed in another order sets the factor: 6.7e-5 in the
# composite group (with global-norm clipping all grew to ~1e-4)
COND_PROMPT, COND_UPDATES, COND_LONG_B, COND_LONG_PROMPT = 160, 3, 4, 1984
# one bf16 denoiser forward, kernels against plain versions, the least row
# cosine: the conditioned and null outputs sum 8 chains (each held to
# CHAIN_ROW_COS alone) and 12 layers of bf16 rounding (an H100 gave 0.99897
# and 0.9989 in the first runs, against a first bound of 0.999);
# guidance, null + 2 (cond - null), doubles a difference that is small
# against each output at a random init (0.99556), so its rows take the
# DDIM path's bound
COND_ROW_COS, GUIDED_ROW_COS = 0.995, 0.99
OPTIM_DEVICE_REL, OPTIM_STEP_REL = 5e-2, 2e-4
OPTIM_CASES = (
    ("adam", dict(lr_scheduler="inverse_sqrt", warmup_updates=2, weight_decay=0.01)),
    ("adadelta", dict(lr_scheduler="fixed", lr=1.0, weight_decay=0.01)),
    ("lamb", dict(lr_scheduler="polynomial_decay", max_updates=4, power=2.0)),
    ("nag", dict(lr_scheduler="step", lr_decay_period=1, lr_decay=0.5)),
    ("adafactor", dict(lr_scheduler="tri_stage", warmup_steps=1, decay_steps=4)),
    ("adagrad", dict(lr_scheduler="triangular", lr=1e-2, max_lr=5e-2, lr_period_updates=4,
                     initial_accumulator_value=0.1)),
    ("sgd", dict(lr_scheduler="manual", lr=1e-2, momentum=0.9, nesterov=True,
                 update2lr="{'1': 5e-3}")),
    ("composite", dict(lr_scheduler="reduce_lr_on_plateau", composite_default="sgd",
                       composite_groups={"denoiser": {"optimizer": "adafactor",
                                                      "lr_scheduler": "cosine",
                                                      "warmup_init_lr": 1e-3,
                                                      "max_updates": 4}})),
)

# the S2ST chain (bench.py --e2e's shape) and its long form, where the
# subsampled source reaches flash_attention's 2048 keys
S2ST_B, S2ST_FRAMES = 16, 480
LONG_B, LONG_FRAMES = 2, 8448
S2ST_KW = dict(max_iter=15, max_len=256, max_duration=4, max_wav_units=384,
               vocoder_chunk=4, return_steps=True)
S2ST_REPS = 3
SECONDS_PER_FRAME = 0.01     # 10 ms fbank shift
VOCODER_CFG = dict(num_embeddings=1000, embedding_dim=128, upsample_rates=[5, 4, 4, 2, 2],
                   upsample_kernel_sizes=[11, 8, 8, 4, 4], upsample_initial_channel=512,
                   resblock_kernel_sizes=[3, 7, 11],
                   resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                   dur_predictor_params={"var_pred_hidden_dim": 256})
# the S2ST chain through the kernels against the plain-version run. At CVSS
# length no kernel runs and the two runs are the same computation: units
# equal, waveform row-cos 1. In long form the kernel's encoder attention
# differs from its plain version by sum order, an ulp of bf16 here and
# there, and the random decoder's bf16 logits (tens in size, ulps of 0.125
# to 0.25) hold near-ties, so an argmax flips and the mask-predict
# trajectories part: the chain's units are held to a share of equal
# positions, and one decoder forward over a fixed canvas (teacher-forced, no
# trajectory) to its logits' row-cos and argmax agreement. On an H100 the
# long form gave 0.7222 of units equal, logits row-cos 0.999992 and argmax
# agreement 1.0, waveform row-cos 0.999987: a random-init vocoder's waveform
# hardly depends on its units, so that bound says little there.
# the int8 NAR decode with static scales (phase 16): 8 sites a conformer
# layer, 10 a decoder layer. Against the bf16 decode: on the CPU the same
# seeded full-width models (B16 x 480, calibrated on the first batch) gave
# 0.4484 of reduced units equal, while one decoder forward over a fixed
# canvas gave logits row-cos min 0.99993 and argmax agreement 1.0 (encoder
# output row-cos min 0.99949): int8 moves the length head's and the
# re-mask's near-ties of a random decoder, the trajectories part, and a
# reduced sequence that gains or loses a unit shifts every later position.
# The unit bound is about half the CPU's share (broken scales give chance,
# ~0.001); the teacher-forced bounds hold the int8 arithmetic itself
S2ST_INT8_SITES = 12 * 8 + 6 * 10
S2ST_INT8_UNIT_AGREE, S2ST_INT8_LOGIT_ROW_COS, S2ST_INT8_ARGMAX_AGREE = 0.25, 0.999, 0.99
S2ST_WAV_ROW_COS, LONG_WAV_ROW_COS = 0.99999, 0.9999
LONG_UNIT_AGREE, LONG_LOGIT_ROW_COS, LONG_ARGMAX_AGREE = 0.5, 0.9999, 0.99
# prep (DiffNorm's first stage, cli.prepare): bench.py --prepare's program,
# B8 x 10 s of 16 kHz audio through mHuBERT-base to layer 11 in bf16, then the
# K=1000 argmin on float32 features; and one 70 s utterance in float32 (the
# CLI's type), whose 3499 frames send each layer's self-attention to
# flash_attention
PREP_B, PREP_SAMPLES, PREP_LAYER, PREP_K, PREP_REPS = 8, 160_000, 11, 1000, 5
PREP_LONG_SAMPLES, PREP_LONG_FRAMES, SAMPLE_RATE = 1_120_000, 3499, 16000
PREP_CHUNK_FRAMES = 4999  # cli.prepare's longest chunk, 100 s (prepare.CHUNK samples)
PREP_CLI_UTTS = 24  # 3-7 s each, beside one of PREP_LONG_SAMPLES
# the long form through the kernel against the plain versions: float32 sums
# in another order over 11 layers; units under a codebook fitted to the
# plain run's features, where only near-ties may differ. bf16 against
# float32 at the bench shape: on the CPU the same seeded model gave row-cos
# 0.99993 and max-abs/scale 1.6e-2; bounds 10x and 3x those, to catch a
# broken bf16 convolution (the CPU's oneDNN grouped one had row-cos 0.08)
PREP_ROW_COS, PREP_REL, PREP_UNIT_AGREE = 0.99999, 1e-4, 0.99
PREP_BF16_ROW_COS, PREP_BF16_REL = 0.999, 5e-2
# the eval chain (phase 15, scripts/s2ut_eval.sh): 16 CVSS-length sources and
# one long-form source whose subsampled frames reach flash_attention, batched
# by the recipe's --max-tokens; the ASR is wav2vec2-large-960h-lv60-self's
# shape (HF config.json), seeded, with its 32-token English vocabulary
EVAL_SHORT, EVAL_SHORT_FRAMES, EVAL_LONG_FRAMES, EVAL_MAX_TOKENS = 16, 480, 8448, 20000
EVAL_MAX_ITER = 15  # --iter-decode-max-iter
EVAL_WIDTH_FLAGS: list = []  # the released nar_s2ut_conformer: the CLI's defaults
ASR_CONFIG = dict(
    model_type="wav2vec2", architectures=["Wav2Vec2ForCTC"], hidden_size=1024,
    num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096, conv_dim=[512] * 7,
    conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2], conv_bias=True,
    feat_extract_norm="layer", do_stable_layer_norm=True, num_conv_pos_embeddings=128,
    num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5, hidden_act="gelu",
    feat_extract_activation="gelu", vocab_size=32)
ASR_VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|", "E", "T", "A", "O", "N", "I", "H", "S", "R",
             "D", "L", "U", "M", "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X", "J",
             "Q", "Z"]
# recipe stage 6 (phase 17): scripts/full_recipe.sh's --batch-size 32
# --crop-units 28, the update timed after warm-up; one update on the card
# (TF32 off) against the port's CPU float32 update on the batch's first rows.
# loss_d is computed before any update: float32 sums in another order. The
# other metrics follow one AdamW step of the discriminators, whose first
# step is lr x sign(g) where the gradient is far above eps, so a near-zero
# gradient whose sign the sum order flips moves its parameter by 2 lr; such
# parameters barely move the loss
GAN_B, GAN_CROP, GAN_WARMUP, GAN_TIMED, GAN_CHECK_B, GAN_CLI_UTTS = 32, 28, 2, 5, 2, 24
GAN_LOSS_D_REL, GAN_G_REL = 1e-4, 1e-3
# the normalizer wherever its checkpoints are written and read (phases 9,
# 18, 21c, 22c and 22f): the released widths, its depth cut to one WaveNet
# stack, two denoiser layers and one VAE decoder layer: 96 M parameters of
# its 399 M (whose fairseq envelope is 4.8 GB, a step directory with Adam's
# moments several GB). At full depth, writing and reading them took most of
# those phases' time. Phases 3-4, 8, 21a-b and 22d keep every layer
CLI_NORMALIZER = dict(denoiser_depth=2, wavenet_stacks=1, vae_decoder_depth=1)
# the NAR's depth likewise in phases 18 and 22a (two encoder and two decoder
# layers at the released widths): its envelope, averaged checkpoints, step
# directories and loader runs' saves shrink with it, and what those phases
# check (conversion, decode and validation against in-process runs, the
# warm start's loss, the loader's batches and resumption) holds at any depth
CLI_NAR_DEPTH = ["--encoder-layers", "2", "--decoder-layers", "2"]
# checkpoints in (phase 18): the builders' seeds and widths (the normalizer
# at CLI_NORMALIZER's depth, the NAR at CLI_NAR_DEPTH's, the discriminators
# at full width). The
# CLI's validation against the in-process criterion: the same float32
# forward of the same weights on the same card and draws, only the weights'
# path differs (the step directory against the in-process conversion). The
# warm start's first loss against an in-process update from the averaged
# weights: the same bf16 forward on the same batch and dropout draws
CKPT_SEED, CKPT_DIFFUSION, CKPT_DISC_WIDTH = 180, CLI_NORMALIZER, 1.0
VALID_REL, WARM_LOSS_REL = 1e-5, 1e-5
# the ASR on the card (float32, TF32 off) against the port's CPU float32
# forward on the same wavs: float32 sums in other orders over 24 layers
ASR_CHECK_WAVS, ASR_ROW_COS, ASR_ARGMAX_AGREE = 4, 0.9999, 0.99
# the NAR model's options (phase 19): n_frames_per_step 2, 256-d target
# speaker embeddings, --multitask-ctc-vocab over a 28-letter dictionary (+ 4
# specials), and the three aux tasks of fairseq's
# examples/speech_to_speech/docs/direct_s2st_discrete_units.md (name, decoder
# type, tap, loss weight), the decoder args at their defaults (2 layers, 256
# wide, 4 heads, FFN 2048) with dropout 0, so the heads' attention may take
# the kernel; the multi-speaker vocoder's speaker count is seeded
OPT_K, OPT_SPK_DIM, OPT_SPEAKERS = 2, 256, 200
OPT_LETTERS = list("abcdefghijklmnopqrstuvwxyz'|")
OPT_TASKS = (("source_letter", "transformer", "encoder_layer", 6, 8.0),
             ("target_letter", "transformer", "encoder_layer", 8, 8.0),
             ("decoder_target_ctc", "ctc", "decoder_layer", 3, 1.6))
# flash_attention launches per long-form forward: the NAT decoder's 6 encoder
# attentions and the two transformer heads' 2 + 2 cross-attentions
OPT_FLASH_PER_FORWARD = 6 + 2 * 2
# the S2ST options left out until phase 20: a 2-member ensemble of the
# released NAR (12 flash_attention launches a long-form decoder forward),
# decoded with the history in chunks of EXTRAS_CHUNK rows (CVSS length,
# long form); chunked against unchunked, bf16 GEMMs at another M part
# near-tied trajectories, so a share of equal units is held (a broken
# reassembly gives chance, ~0.001), as phase 16's int8 decode is. The remat
# update against the one without: the same forward (loss within 1e-6) and a
# backward whose sums may differ in order (gnorm within 1e-4). The augments
# at the recipe's shapes: noise WAVs of 1-3 s, 32 vocoder utterances (B32 x
# 28 units); repr_to_speech at B32 x 32 frames of 768-d features
EXTRAS_MEMBERS, EXTRAS_REPS, EXTRAS_CHUNK = 2, 3, {S2ST_FRAMES: 4, LONG_FRAMES: 1}
EXTRAS_CHUNK_AGREE, REMAT_LOSS_REL, REMAT_GNORM_REL = 0.25, 1e-6, 1e-4
AUG_NOISES, AUG_VOCODER_UTTS, FEAT_UTTS, FEAT_CROP = 8, 32, 32, 32


# ---- seeded fairseq-layout state dicts (phase 18; tests/test_torch_convert.py)
# The key layout is the one the converters read (diffnorm_tpu_torch/utils/
# convert_weights.py, after diffnorm_tpu/utils/convert_weights.py): weights
# N(0, 1 / fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), with
# the buffers fairseq's save path emits.


class SeededStateDict(dict):
    """A state dict of seeded float32 CPU tensors, drawn in insertion order."""

    def __init__(self, torch, seed: int):
        import numpy as np

        super().__init__()
        self.torch, self.rng = torch, np.random.default_rng(seed)

    def put(self, key: str, array) -> None:
        import numpy as np

        self[key] = self.torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))

    def normal(self, key: str, shape, scale: float, shift: float = 0.0) -> None:
        self.put(key, self.rng.standard_normal(tuple(shape), dtype="float32") * scale + shift)

    def weight(self, key: str, *shape) -> None:
        self.normal(key, shape, math.prod(shape[1:]) ** -0.5)

    def linear(self, prefix: str, out: int, inp: int, bias: bool = True) -> None:
        self.weight(f"{prefix}.weight", out, inp)
        if bias:
            self.normal(f"{prefix}.bias", (out,), 0.1)

    def conv(self, prefix: str, out: int, inp: int, k: int, bias: bool = True) -> None:
        self.weight(f"{prefix}.weight", out, inp, k)
        if bias:
            self.normal(f"{prefix}.bias", (out,), 0.1)

    def norm(self, prefix: str, dim: int) -> None:
        self.normal(f"{prefix}.weight", (dim,), 0.1, 1.0)
        self.normal(f"{prefix}.bias", (dim,), 0.1)


def _fairseq_wavenet(sd: SeededStateDict, prefix: str, c_in: int, c: int, stacks: int,
                     layers: int, cond_dim=None) -> None:
    """Wavenet / WavenetEncoder (latent_module.py:585-617, 1003-1032): the
    skip convs on the last stack, FiLM time projections where conditioned."""
    sd.conv(f"{prefix}.init_conv", c, c_in, 3)
    for s in range(stacks):
        for j in range(layers):
            b = f"{prefix}.stacks.{s}.blocks.{j}"
            if cond_dim:
                sd.linear(f"{b}.to_time_cond", 2 * c, cond_dim)
            sd.conv(f"{b}.conv", c, c, 3)
            sd.conv(f"{b}.res_conv", c, c, 1)
            if s == stacks - 1:
                sd.conv(f"{b}.skip_conv", c, c, 1)
    sd.conv(f"{prefix}.final_conv", c, c, 1)


def _fairseq_transformer(sd: SeededStateDict, prefix: str, dim: int, depth: int,
                         dim_head: int, heads: int, cond_dim=None) -> None:
    """ConditionableTransformer (latent_module.py:642-706) with the causal-conv
    GEGLU FF: per layer [norm, attention, None, None, norm, FF]."""
    inner, ff = heads * dim_head, int(dim * 4 * 2 / 3)
    for i in range(depth):
        lp = f"{prefix}.layers.{i}"
        for n in (0, 4):
            if cond_dim:
                sd.linear(f"{lp}.{n}.to_gamma_beta", 2 * dim, cond_dim)
            else:
                sd.normal(f"{lp}.{n}.gamma", (dim,), 0.1, 1.0)
        sd.linear(f"{lp}.1.to_q", inner, dim, bias=False)
        sd.linear(f"{lp}.1.to_kv", 2 * inner, dim, bias=False)
        sd.linear(f"{lp}.1.to_out", dim, inner, bias=False)
        sd.linear(f"{lp}.5.0", 2 * ff, dim)
        sd.conv(f"{lp}.5.2.1", ff, ff, 3)
        sd.linear(f"{lp}.5.3", dim, ff)
    sd.normal(f"{prefix}.to_pred.0.gamma", (dim,), 0.1, 1.0)
    sd.linear(f"{prefix}.to_pred.1", dim, dim, bias=False)


def _fairseq_vae(sd: SeededStateDict, prefix: str, feature_dim: int = 768,
                 latent_dim: int = 128, vocab_size: int = 1004, decoder_depth: int = 6,
                 decoder_dim_head: int = 96, decoder_heads: int = 8, chan_mults=None) -> None:
    """SpeechVAEEncoderDecoder (latent_module.py:1035-1142) under `prefix`."""
    mults = list(chan_mults) if chan_mults else {16: [4, 3, 2], 32: [4, 3], 128: [3]}[latent_dim]
    cur = feature_dim
    for i, m in enumerate(mults):
        _fairseq_wavenet(sd, f"{prefix}encoder_wave.{i}", cur, cur // m, 2, 3)
        cur //= m
    c_in = latent_dim
    for i, m in enumerate(reversed(mults)):
        _fairseq_wavenet(sd, f"{prefix}decoder_wave.{i}", c_in, cur * m, 2, 3)
        cur = c_in = cur * m
    _fairseq_transformer(sd, f"{prefix}decoder_tf", feature_dim, decoder_depth,
                         decoder_dim_head, decoder_heads)
    sd.linear(f"{prefix}decoder_lm", vocab_size, feature_dim)


def fairseq_vae_state(torch, seed: int, **widths) -> SeededStateDict:
    """A `speech_vae_decoder` model's state dict (the VAE under `encoder.`);
    `widths` are SpeechVAEModule's (feature_dim for its dim)."""
    sd = SeededStateDict(torch, seed)
    _fairseq_vae(sd, "encoder.", **widths)
    return sd


def fairseq_diffusion_state(torch, seed: int, dim: int = 512, latent_dim: int = 128,
                            feature_dim: int = 768, vocab_size: int = 1004,
                            denoiser_depth: int = 12, wavenet_layers: int = 8,
                            wavenet_stacks: int = 4, vae_decoder_depth: int = 6,
                            vae_decoder_dim_head: int = 96, vae_decoder_heads: int = 8,
                            chan_mults=None) -> SeededStateDict:
    """A `diff_discrete` model's state dict (LatentDiscreteModel under
    `encoder.`: the frozen VAE at `speech_decoder.`, the denoiser `Model`
    at `model.`, latent_module.py:709-876) at LatentDiffusionModule's
    widths (the released ones by default)."""
    sd = SeededStateDict(torch, seed)
    p, cond = "encoder.model.", 4 * dim
    sd.normal(f"{p}to_time_cond.0.weights", (dim // 2,), 1.0)
    sd.linear(f"{p}to_time_cond.1", cond, dim + 1)
    sd.conv(f"{p}init_conv", dim, latent_dim, 1)
    _fairseq_wavenet(sd, f"{p}wavenet", dim, dim, wavenet_stacks, wavenet_layers, cond)
    _fairseq_transformer(sd, f"{p}transformer", dim, denoiser_depth, 64, 8, cond)
    sd.linear(f"{p}final_proj", latent_dim, dim)
    _fairseq_vae(sd, "encoder.speech_decoder.", feature_dim, latent_dim, vocab_size,
                 vae_decoder_depth, vae_decoder_dim_head, vae_decoder_heads, chan_mults)
    return sd


def fairseq_nar_state(torch, seed: int, vocab_size: int = 1004, in_channels: int = 80,
                      dim: int = 512, ffn_dim: int = 2048, encoder_layers: int = 12,
                      encoder_heads: int = 8, decoder_layers: int = 6, decoder_heads: int = 8,
                      depthwise_kernel_size: int = 31, conv_channels: int = 1024,
                      conv_kernel_sizes=(5, 5), max_lengths: int = 256) -> SeededStateDict:
    """A `nar_s2ut_conformer` model's state dict (S2SConformerEncoder +
    TransformerUnitDecoder, research/TranSpeech nar_conformer.py and
    nar_transformer.py) with the shared output projection
    (--share-decoder-input-output-embed), BatchNorm running statistics and
    the version and sinusoidal buffers, at NARS2UTModule's widths."""
    sd = SeededStateDict(torch, seed)
    n = len(conv_kernel_sizes)
    for i, k in enumerate(conv_kernel_sizes):
        sd.conv(f"encoder.subsample.conv_layers.{i}",
                conv_channels if i < n - 1 else 2 * dim,
                in_channels if i == 0 else conv_channels // 2, k)
    sd.linear("encoder.linear", dim, dim)
    for i in range(encoder_layers):
        p = f"encoder.conformer_layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            sd.norm(f"{p}.{ffn}.layer_norm", dim)
            sd.linear(f"{p}.{ffn}.w_1", ffn_dim, dim)
            sd.linear(f"{p}.{ffn}.w_2", dim, ffn_dim)
        sd.norm(f"{p}.self_attn_layer_norm", dim)
        for q in ("linear_q", "linear_k", "linear_v", "linear_out"):
            sd.linear(f"{p}.self_attn.{q}", dim, dim)
        sd.linear(f"{p}.self_attn.linear_pos", dim, dim, bias=False)
        for u in ("pos_bias_u", "pos_bias_v"):
            sd.normal(f"{p}.self_attn.{u}", (encoder_heads, dim // encoder_heads), 0.1)
        c = f"{p}.conv_module"
        sd.norm(f"{c}.layer_norm", dim)
        sd.conv(f"{c}.pointwise_conv1", 2 * dim, dim, 1, bias=False)
        sd.conv(f"{c}.depthwise_conv", dim, 1, depthwise_kernel_size, bias=False)
        sd.norm(f"{c}.batch_norm", dim)
        sd.normal(f"{c}.batch_norm.running_mean", (dim,), 0.1)
        sd.put(f"{c}.batch_norm.running_var", 1.0 + abs(sd.rng.standard_normal(dim) * 0.2))
        sd[f"{c}.batch_norm.num_batches_tracked"] = torch.tensor(1000)
        sd.conv(f"{c}.pointwise_conv2", dim, dim, 1, bias=False)
        sd.norm(f"{p}.final_layer_norm", dim)
    sd.normal("decoder.embed_tokens.weight", (vocab_size, dim), dim ** -0.5)
    sd.normal("decoder.embed_length.weight", (max_lengths, dim), dim ** -0.5)
    sd["decoder.embed_positions._float_tensor"] = torch.zeros(1)
    for i in range(decoder_layers):
        p = f"decoder.layers.{i}"
        for attn in ("self_attn", "encoder_attn"):
            for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd.linear(f"{p}.{attn}.{q}", dim, dim)
            sd.norm(f"{p}.{attn}_layer_norm", dim)
        sd.linear(f"{p}.fc1", ffn_dim, dim)
        sd.linear(f"{p}.fc2", dim, ffn_dim)
        sd.norm(f"{p}.final_layer_norm", dim)
    sd.norm("decoder.layer_norm", dim)
    sd["decoder.output_projection.weight"] = sd["decoder.embed_tokens.weight"]
    sd["decoder.version"] = torch.tensor([3.0])
    return sd


def _weight_norm(sd: SeededStateDict, prefix: str, shape) -> None:
    """torch weight_norm (dim 0): weight_g [out, 1, ...] and weight_v."""
    sd.weight(f"{prefix}.weight_v", *shape)
    sd.normal(f"{prefix}.weight_g", (shape[0],) + (1,) * (len(shape) - 1), 0.1, 1.0)


def _spectral_norm(sd: SeededStateDict, prefix: str, shape) -> None:
    """torch spectral_norm: weight_orig and the unit power-iteration vectors
    weight_u [out] and weight_v [in * k]."""
    import numpy as np

    sd.weight(f"{prefix}.weight_orig", *shape)
    for key, n in (("weight_u", shape[0]), ("weight_v", math.prod(shape[1:]))):
        v = sd.rng.standard_normal(n)
        sd.put(f"{prefix}.{key}", v / np.linalg.norm(v))


def fairseq_discriminator_states(torch, seed: int, width: float = 1.0,
                                 periods=(2, 3, 5, 7, 11), scales: int = 3):
    """(mpd, msd) state dicts of TranSpeech hifigan's MultiPeriod and
    MultiScale discriminators (research/TranSpeech/hifigan/models.py:128-249)
    at models/hifigan_disc.py's `width`: weight-normed convs, the first
    scale spectral-normed."""
    from diffnorm_tpu_torch.models.hifigan_disc import PERIOD_CHANNELS, scale_specs

    mpd = SeededStateDict(torch, seed)
    chans = [max(4, int(c * width)) for c in PERIOD_CHANNELS]
    for i, _ in enumerate(periods):
        c_in = 1
        for j, ch in enumerate(chans + [chans[-1]]):
            _weight_norm(mpd, f"discriminators.{i}.convs.{j}", (ch, c_in, 5, 1))
            mpd.normal(f"discriminators.{i}.convs.{j}.bias", (ch,), 0.1)
            c_in = ch
        _weight_norm(mpd, f"discriminators.{i}.conv_post", (1, c_in, 3, 1))
        mpd.normal(f"discriminators.{i}.conv_post.bias", (1,), 0.1)
    msd = SeededStateDict(torch, seed + 1)
    for s in range(scales):
        norm = _spectral_norm if s == 0 else _weight_norm
        c_in = 1
        for j, (ch, k, _, g) in enumerate(scale_specs(width)):
            norm(msd, f"discriminators.{s}.convs.{j}", (ch, c_in // g, k))
            msd.normal(f"discriminators.{s}.convs.{j}.bias", (ch,), 0.1)
            c_in = ch
        norm(msd, f"discriminators.{s}.conv_post", (1, c_in, 3))
        msd.normal(f"discriminators.{s}.conv_post.bias", (1,), 0.1)
    return mpd, msd


def fairseq_envelope(torch, sd, criterion: str = "label_smoothed_cross_entropy") -> dict:
    """The released-checkpoint wrapper of fairseq's save path
    (checkpoint_utils.py:35-186, as tests/test_convert_released_inventory.py
    writes it): cfg, the model state, optimizer history, extra_state and the
    last optimizer state with Adam moments for every float tensor."""
    flat = list(sd.items())
    last_opt = {
        "state": {i: {"step": torch.tensor(100), "exp_avg": torch.zeros_like(v.float()),
                      "exp_avg_sq": torch.zeros_like(v.float())}
                  for i, (_, v) in enumerate(flat) if v.dtype.is_floating_point},
        "param_groups": [{"lr": 5e-4, "betas": (0.9, 0.98), "eps": 1e-8, "weight_decay": 0.0,
                          "params": list(range(len(flat)))}],
    }
    return {"args": None,
            "cfg": {"model": {"_name": "x"}, "task": {"_name": "y"},
                    "criterion": {"_name": criterion}},
            "model": dict(sd), "criterion": None,
            "optimizer_history": [{"criterion_name": criterion,
                                   "optimizer_name": "FairseqAdam",
                                   "lr_scheduler_state": {"best": None},
                                   "num_updates": 100}],
            "task_state": {},
            "extra_state": {"metrics": {}, "previous_training_time": 1.0,
                            "train_iterator": {"epoch": 3}, "val_loss": 2.5},
            "last_optimizer_state": last_opt}


def discriminator_envelope(torch, mpd, msd) -> dict:
    """A hifigan fine-tune's `do_*` checkpoint: both discriminators, their
    optimizer state, steps and epoch."""
    return {"mpd": dict(mpd), "msd": dict(msd),
            "optim_d": {"state": {}, "param_groups": [{"lr": 2e-4, "betas": (0.8, 0.99)}]},
            "steps": 500000, "epoch": 100}


class LogLines(logging.Handler):
    """Keeps the messages a logger emits."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def cuda_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call: `iters` calls captured in a CUDA graph, replayed
    `reps` times between CUDA events; the median per-call time. A graph
    keeps Python's launch overhead (tens of us per wrapper call) out of a
    kernel's time. Inputs stay hot in L2 across calls, as they are on the
    DDIM path, where the previous op has just written them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def cuda_time_cold_ms(fn, *inputs) -> float:
    """cuda_time_ms of fn(*inputs) with the inputs rotated through copies
    that together fill twice the L2, so that each call reads them from HBM
    (where the L2 would hold one set, a hot replay beats the byte bound)."""
    n = 2 * L2_BYTES // sum(x.numel() * x.element_size() for x in inputs) + 1
    sets = itertools.cycle([[x.clone() for x in inputs] for _ in range(n)])
    return cuda_time_ms(lambda: fn(*next(sets)), iters=n * math.ceil(20 / n))


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_rms_norm_film(torch, norm, b=B, t=T, cold=False):
    """rms_norm_film at [b, t, 512] in bf16 and float32 against its plain
    version, timed beside its bound (with the inputs hot in L2, or read
    from HBM where `cold`); the bf16 numbers."""

    def timed(fn, *inputs):
        return cuda_time_cold_ms(fn, *inputs) if cold else cuda_time_ms(lambda: fn(*inputs))

    where = ", inputs from HBM" if cold else ""
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(b, t, 512, generator=g, device="cuda").to(torch.bfloat16)
    film = torch.randn(b, 1024, generator=g, device="cuda").to(torch.bfloat16)
    got = norm.rms_norm_film(x, film).float()
    ref = norm.rms_norm_film_plain(x, film).float()  # f32 math, rounded to bf16
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    # where y * gamma + beta cancels, the kernel's fused multiply-add and
    # PyTorch's two roundings differ by an f32 rounding of the summands,
    # which can exceed a bf16 ulp of the near-zero result: allow 4 f32 ulps
    # of |y * gamma| + |beta| on top
    summands = norm_summands(torch, x, film)
    tol = ulp + summands * 2.0 ** -21
    err = (got - ref).abs()
    if not torch.isfinite(got).all() or (err > tol).any():
        fail(f"rms_norm_film: {(err > tol).sum().item()} elements beyond tolerance, "
             f"max err {err.max().item():.3e}")
    ms = timed(norm.rms_norm_film, x, film)
    plain_ms = timed(norm.rms_norm_film_plain, x, film)
    nbytes = 2 * x.numel() * 2 + film.numel() * 2
    bound_ms, bound_by = bound(nbytes, 5.0 * x.numel(), F32_FLOP_PER_S)
    print(f"kernel rms_norm_film [{b},{t},512] bf16{where}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), max_abs_err "
          f"{err.max().item():.3e}, {(err > ulp).sum().item()} of {err.numel()} elements beyond 1 bf16 ulp "
          f"(all within 1 ulp + 4 f32 ulps of the summands)")

    # float32: the same f32 math, no rounding to bf16 at the end; rsqrtf and
    # the sum order move the result by a few f32 ulps of the summands
    x32, film32 = x.float(), film.float()
    got = norm.rms_norm_film(x32, film32)
    ref = norm.rms_norm_film_plain(x32, film32)
    err32 = (got - ref).abs()
    tol = norm_summands(torch, x32, film32) * 2.0 ** -18
    if not torch.isfinite(got).all() or (err32 > tol).any():
        fail(f"rms_norm_film float32: {(err32 > tol).sum().item()} elements beyond 32 f32 "
             f"ulps of the summands, max err {err32.max().item():.3e}")
    ms32 = timed(norm.rms_norm_film, x32, film32)
    plain32 = timed(norm.rms_norm_film_plain, x32, film32)
    bound32, _ = bound(2 * nbytes, 5.0 * x.numel(), F32_FLOP_PER_S)
    print(f"kernel rms_norm_film [{b},{t},512] float32{where}: {ms32:.4f} ms, plain "
          f"{plain32:.4f} ms, bound {bound32:.4f} ms (bytes), max_abs_err "
          f"{err32.max().item():.3e} (within 32 f32 ulps of the summands)")
    return dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def norm_summands(torch, x, film):
    """|y * gamma| + |beta| of the norm, in f32: the scale of its rounding."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().sum(-1, keepdim=True).clamp(min=1e-24)) * x.shape[-1] ** 0.5
    gamma, beta = film.float()[:, None, :].chunk(2, dim=-1)
    return (y * gamma).abs() + beta.abs()


def chain_inputs(torch, c, s, k, seed, b=B, t=T, dtype=None):
    """Random chain inputs: x [b, t, c] and the weights [out, in] in `dtype`
    (bf16 by default), gamma and beta' float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.bfloat16

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return dict(
        x=rnd(b, t, c).to(dtype),
        w_conv=rnd(s, k, c, c, scale=(k * c) ** -0.5).to(dtype),
        w_res=rnd(s, c, c, scale=c ** -0.5).to(dtype),
        w_skip=rnd(c, c, scale=c ** -0.5).to(dtype),
        b_res=rnd(s, c, scale=0.3).to(dtype),
        b_skip=rnd(c, scale=0.3).to(dtype),
        gamma=1.0 + rnd(b, s, c, scale=0.5),
        beta=rnd(b, s, c, scale=0.3),
    )


def chain_work(c, s, k, dilation, inputs):
    """Bytes the call must move and the operations this shape needs (a tap
    whose shift reaches T multiplies nothing but zeros)."""
    x = inputs["x"]
    b, t = x.shape[:2]
    live_rows = sum(max(t - (k - 1 - i) * dilation, 0) for i in range(k))
    flops = 2.0 * b * c * c * (s * (live_rows + t) + t)
    nbytes = sum(v.numel() * v.element_size() for v in inputs.values()) + x.numel() * x.element_size()
    return nbytes, flops


# (what, B, T, C, S, dilation): the shapes the DDIM path runs, timed (the
# denoiser's 8 dilations and the VAE's WaveNets), then edges checked only:
# two M tiles per sequence with the second ragged, every shifted tap dead
# (d 32 at T 37 shifts by 64 and 32, d 128 by 256 and 128), ragged K and N
CHAIN_PATH_CASES = ([("denoiser", B, T, 512, 4, d) for d in (1, 2, 4, 8, 16, 32, 64, 128)]
                    + [("vae encoder", B, T, 256, 2, 4), ("vae decoder", B, T, 768, 2, 1)])
CHAIN_EDGE_CASES = [("T=200", 4, 200, 512, 4, 1), ("T=200", 4, 200, 512, 4, 64),
                    ("T=37", 4, 37, 512, 4, 32), ("T=37", 4, 37, 512, 4, 128),
                    ("C=200", 4, 37, 200, 2, 1)] + [
    # phase 29's dummy_vae cli.train runs: B8 x T400, each WaveNet's three chains
    (f"dummy_vae {part}", 8, 400, c, 2, d)
    for part, c in (("encoder", 256), ("decoder", 768)) for d in (1, 2, 4)]
CHAIN_F32_CASES = [("denoiser", B, T, 512, 4, 1), ("denoiser", B, T, 512, 4, 64),
                   ("T=200", 4, 200, 512, 4, 64), ("T=37", 4, 37, 512, 4, 32),
                   ("C=200", 4, 37, 200, 2, 1)]


def check_wavenet_chain(torch, chain):
    """Every case against the plain version: bf16 at CHAIN_ROW_COS and
    CHAIN_REL_ERR, float32 at CHAIN_F32_REL_ERR. The path's shapes are timed;
    the kernel line keeps the bf16 denoiser mean, and the float32 times go on
    their own line."""
    denoiser = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
    bound_by, f32_times = None, []
    cases = ([(c, torch.bfloat16, True) for c in CHAIN_PATH_CASES]
             + [(c, torch.bfloat16, False) for c in CHAIN_EDGE_CASES]
             + [(c, torch.float32, c[1] == B) for c in CHAIN_F32_CASES])
    for n, ((what, b, t, c, s, d), dtype, timed) in enumerate(cases):
        inp = chain_inputs(torch, c, s, 3, seed=20 + n, b=b, t=t, dtype=dtype)
        got = chain.wavenet_chain(**inp, dilation=d).float()
        ref = chain.wavenet_chain_plain(**inp, dilation=d).float()
        torch.cuda.synchronize()
        cos = torch.nn.functional.cosine_similarity(
            got.reshape(-1, c), ref.reshape(-1, c), dim=-1).min().item()
        err = (got - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        kind = str(dtype)[6:]
        label = f"wavenet_chain {what} [{b},{t},{c}] S={s} d={d} {kind}"
        bad = (rel > CHAIN_F32_REL_ERR if dtype == torch.float32
               else cos <= CHAIN_ROW_COS or rel >= CHAIN_REL_ERR)
        if not torch.isfinite(got).all() or bad:
            fail(f"{label}: row-cos {cos:.6f}, max-abs/scale {rel:.3e}")
        if not timed:
            print(f"kernel {label}: row-cos {cos:.6f}, max-abs/scale {rel:.2e}")
            continue
        ms = cuda_time_ms(lambda: chain.wavenet_chain(**inp, dilation=d))
        plain_ms = cuda_time_ms(lambda: chain.wavenet_chain_plain(**inp, dilation=d),
                                iters=3, reps=3)
        nbytes, flops = chain_work(c, s, 3, d, inp)
        bound_ms, by = bound(nbytes, flops,
                             F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S)
        print(f"kernel {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}), {flops / ms / 1e9:.1f} TFLOP/s, row-cos {cos:.6f}, "
              f"max-abs/scale {rel:.2e}")
        if dtype == torch.float32:
            f32_times.append(f"d={d} {ms:.4f} ms (bound {bound_ms:.4f}, plain {plain_ms:.4f})")
        elif what == "denoiser":
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                denoiser[key] += val / 8
            denoiser["max_abs_err"] = max(denoiser["max_abs_err"], err)
            bound_by = by
    print(f"kernel wavenet_chain float32 at [{B},{T},512] S=4: " + "; ".join(f32_times)
          + f"; every float32 case within max-abs/scale {CHAIN_F32_REL_ERR}")
    inp = chain_inputs(torch, 512, 4, 3, seed=19)
    for d in (1, 64):
        split = launch_split(torch, lambda: chain.wavenet_chain(**inp, dilation=d))
        print(f"kernel wavenet_chain denoiser d={d} per launch (torch.profiler, median of 5 "
              f"calls): " + ("not measured (the profiler saw no device time)" if split is None
                             else "; ".join(f"{name[:40]} {us:.1f} us" for name, us in split)))
    print(f"kernel wavenet_chain: one denoiser step's 8 chains {8 * denoiser['ms']:.4f} ms, "
          f"bound {8 * denoiser['bound_ms']:.4f} ms")
    return dict(denoiser, bound_by=bound_by)


def ff_pack(torch, ffpipe, seed):
    """Random float32 FF weights at the released width, packed for the
    kernels (lecun-normal scales, small non-zero biases)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return ffpipe.pack_ff_weights(
        rnd(2 * INNER, C, scale=C ** -0.5), rnd(2 * INNER, scale=0.02),
        rnd(INNER, INNER, 3, scale=(3 * INNER) ** -0.5), rnd(INNER, scale=0.02),
        rnd(C, INNER, scale=INNER ** -0.5), rnd(C, scale=0.02))


def agreement(torch, got, ref):
    """Min row-cos, max-abs over the reference's scale, bit-equal share."""
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    cos = torch.nn.functional.cosine_similarity(g, r, dim=-1).min().item()
    err = (g - r).abs().max().item()
    return cos, err / r.abs().max().item(), (g == r).float().mean().item(), err


def ff_work(w):
    """int8 operations and bytes of one FF sublayer call at [B, T, C]."""
    p = w["wxq"].shape[0]
    ops = 2.0 * B * T * (C * 2 * p + 3 * p * p + p * C)
    nbytes = (sum(t.numel() * t.element_size() for t in w.values())
              + 2 * B * T * C * 2 + B * 2 * C * 4)
    return ops, nbytes


def check_ffpipe(torch, ffpipe):
    """ffpipe_layer rows 1 and 2 against the plain version, and each other,
    at EDGE_SHAPES and then at the path's shape, which is timed."""
    w = ff_pack(torch, ffpipe, seed=30)
    g = torch.Generator(device="cuda").manual_seed(31)
    for b, t in (*EDGE_SHAPES, (B, T)):
        x = torch.randn(b, t, C, generator=g, device="cuda").to(torch.bfloat16)
        film = torch.randn(b, 2 * C, generator=g, device="cuda").to(torch.bfloat16)
        got = ffpipe.ffpipe_layer(x, film, w, rows=1)
        got2 = ffpipe.ffpipe_layer(x, film, w, rows=2)
        ref = ffpipe.ffpipe_layer_plain(x, film, w)
        torch.cuda.synchronize()
        if not torch.equal(got, got2):
            fail(f"ffpipe_layer [{b},{t},{C}] rows 2 differs from rows 1 in "
                 f"{(got != got2).sum().item()} elements")
        cos, rel, same, err = agreement(torch, got, ref)
        print(f"kernel ffpipe_layer [{b},{t},{C}] against the plain version: row-cos "
              f"{cos:.6f}, max-abs/scale {rel:.2e}, bit-equal {same:.4f}")
        if (not torch.isfinite(got).all() or cos <= FF_ROW_COS or rel >= FF_REL_ERR
                or same < FF_BIT_EQUAL):
            fail("ffpipe_layer is beyond its tolerance against the plain version")
    ops, nbytes = ff_work(w)
    bound_ms, bound_by = bound(nbytes, ops, INT8_OPS_PER_S)
    results = {}
    for name, rows in (("ffpipe_layer", 1), ("ffpipe_layer2", 2)):
        ms = cuda_time_ms(lambda: ffpipe.ffpipe_layer(x, film, w, rows=rows))
        results[name] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
    plain_ms = cuda_time_ms(lambda: ffpipe.ffpipe_layer_plain(x, film, w), iters=3, reps=3)
    q3 = torch.randint(-127, 128, (B * T, w["wcq"].shape[1]), generator=g, device="cuda",
                       dtype=torch.int8)
    taps = [w["wcq"][i].t() for i in range(3)]
    int_mm_ms = cuda_time_ms(lambda: [torch._int_mm(q3, tap) for tap in taps])
    for name, r in results.items():
        r["plain_ms"] = plain_ms
        print(f"kernel {name} [{B},{T},{C}] P={w['wxq'].shape[0]}: {r['ms']:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{ops / r['ms'] / 1e9:.1f} TOP/s")
    print(f"kernel ffpipe_layer: rows 2 bit-identical to rows 1; reference: torch._int_mm "
          f"for the 3 conv-tap products alone {int_mm_ms:.4f} ms")
    results["int_mm_conv_ms"] = int_mm_ms
    return results


def check_fused_layer(torch, ffpipe, fused):
    """fused_layer against its plain version, with padded keys and (B > 1)
    one row whose keys are all masked, at EDGE_SHAPES and then at the path's
    shape, which is timed with its per-launch split."""
    g = torch.Generator(device="cuda").manual_seed(40)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    w = fused.pack_layer_weights(rnd(C, C, scale=C ** -0.5), rnd(2 * C, C, scale=C ** -0.5),
                                 rnd(C, C, scale=C ** -0.5), ff_pack(torch, ffpipe, seed=41))
    for b, t in (*EDGE_SHAPES, (B, T)):
        x = rnd(b, t, C).to(torch.bfloat16)
        fa, ff = rnd(b, 2 * C).to(torch.bfloat16), rnd(b, 2 * C).to(torch.bfloat16)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device="cuda")
        lengths[0] = t
        if b > 1:
            lengths[1] = 0
        mask = torch.arange(t, device="cuda")[None, :] < lengths[:, None]
        args = (x, mask, fa, ff, w, HEADS, DIM_HEAD)
        got = fused.fused_layer(*args)
        ref = fused.fused_layer_plain(*args)
        torch.cuda.synchronize()
        cos, rel, same, err = agreement(torch, got, ref)
        print(f"kernel fused_layer [{b},{t},{C}] against the plain version: row-cos "
              f"{cos:.6f}, max-abs/scale {rel:.2e}, bit-equal {same:.4f}")
        if not torch.isfinite(got).all() or cos <= LAYER_ROW_COS or rel >= LAYER_REL_ERR:
            fail("fused_layer is beyond its tolerance against the plain version")
    ms = cuda_time_ms(lambda: fused.fused_layer(*args))
    split = launch_split(torch, lambda: fused.fused_layer(*args))
    conv_us = None
    if split is None:
        print("kernel fused_layer per launch: the profiler saw no device time (not measured)")
    else:
        conv_us = next((us for name, us in split if "gemm_kernel<1," in name), None)
        print(f"kernel fused_layer [{B},{T},{C}] per launch (torch.profiler, median of 5 "
              f"calls): " + "; ".join(f"{i + 1} {name[:60]} {us:.1f} us"
                                      for i, (name, us) in enumerate(split))
              + f"; sum {sum(us for _, us in split):.1f} us")
    plain_ms = cuda_time_ms(lambda: fused.fused_layer_plain(*args), iters=3, reps=3)
    int8_ops, nbytes = ff_work({k: v for k, v in w.items() if k not in ("wqkv", "wo")})
    bf16_flops = 2.0 * B * T * (3 * C * C + C * C) + 4.0 * B * HEADS * T * T * DIM_HEAD
    nbytes += (w["wqkv"].numel() + w["wo"].numel()) * 2 + B * T + B * 2 * C * 4
    t_ops = int8_ops / INT8_OPS_PER_S + bf16_flops / BF16_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms, bound_by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    print(f"kernel fused_layer [{B},{T},{C}] {HEADS}x{DIM_HEAD} P={w['wxq'].shape[0]}: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{int8_ops / 1e9:.1f} G int8 ops + {bf16_flops / 1e9:.1f} GFLOP bf16, "
          f"{nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, conv_us=conv_us)


def cuda_time_eager_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call of `iters` eager calls between CUDA events (for
    a library call that a CUDA graph may not capture); median of `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_kernels(torch, fn):
    """The device kernels one call of `fn` runs, by device time (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return [e.key for e in sorted(events, key=lambda e: -e.self_device_time_total)]


def launch_split(torch, fn, reps: int = 5):
    """The device kernels of one call of `fn` in launch order, each with the
    median of its device time over `reps` profiled calls (torch.profiler),
    as [(kernel name, us)]; None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    if not kernels or len(kernels) % reps:
        return None
    n = len(kernels) // reps
    return [(kernels[i].name, statistics.median(
        kernels[r * n + i].time_range.elapsed_us() for r in range(reps))) for i in range(n)]


def check_flash_attention(torch, flash):
    """flash_attention against its plain version: ragged masks, a fully
    masked row, Tq/Tk off the 64 tiles, one key, a key split of one key
    and a short last split, D 32/96/128, float32 (D 24/64/80/96/128); then the
    path's shape and PERFORMANCE.md's, timed beside the plain version,
    F.scaled_dot_product_attention with the same boolean key mask and the
    bound of the valid keys' work."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # (what, B, H, Tq, Tk, D, key lengths, dtype)
        ("odd, a fully masked row", 3, 4, 200, 2100, 64, [2100, 977, 0], bf),
        # at the path's Tq and D: one key; two 64-key tiles split in two, the
        # second of one key; 33 tiles split 7+7+7+7+5, the last tile of 52
        # keys and the later splits of the second row all masked
        ("Tk=1", 2, 8, 256, 1, 64, [1, 0], bf),
        ("Tk=65", 2, 8, 256, 65, 64, [65, 30], bf),
        ("short last split", 2, 8, 256, 2100, 64, [2100, 1000], bf),
        ("Tk=1 float32", 2, 8, 256, 1, 64, [1, 0], f32),
        ("Tk=65 float32", 2, 8, 256, 65, 64, [65, 30], f32),
        ("short last split float32", 2, 8, 256, 2100, 64, [2100, 1000], f32),
        ("D=32", 2, 2, 70, 130, 32, [130, 0], bf),
        ("D=96", 2, 2, 70, 130, 96, [101, 0], bf),
        ("D=128", 2, 2, 70, 130, 128, [130, 64], bf),
        ("float32", 2, 2, 70, 130, 64, [90, 0], f32),
        ("float32 D=80", 1, 2, 33, 77, 80, [50], f32),
        # each padded width's P.V channel chunks (DP 32, 96) over several key tiles
        ("float32 D=24", 1, 3, 100, 150, 24, [150], f32),
        ("float32 D=96", 2, 2, 70, 300, 96, [300, 133], f32),
        ("float32 D=128, a fully masked row", 3, 2, 70, 200, 128, [200, 77, 0], f32),
        ("path", 2, 8, 256, 2112, 64, [2112, 1056], bf),
        # phase 15's long batch: 8448 and 480 frames padded to the 12288 bucket
        ("eval path", 2, 8, 256, 3072, 64, [2112, 120], bf),
        ("PERFORMANCE.md", 2, 8, 4096, 4096, 64, [4096, 3001], bf),
        # the AR beam decode's encoder attention, one query a row: B2 x beam
        # 5 rows, each sentence's beams contiguous, the second half length
        ("AR decode step", 10, 8, 1, 2112, 64, [2112] * 5 + [1056] * 5, bf),
        # s2ut_transformer's encoder self-attention in long form (phase 23c)
        ("S2T encoder", 2, 8, 2112, 2112, 64, [2112, 1056], bf),
        # phase 24's decode steps: UnitY's first pass (256 wide, 8 heads)
        # and Translatotron2's (512 wide, 4 heads), beam 5 on B2, and
        # s2spect's mel decoder (512 wide, 4 heads), one row a sentence
        ("UnitY decode step", 10, 8, 1, 2112, 32, [2112] * 5 + [1056] * 5, bf),
        ("Translatotron2 decode step", 10, 4, 1, 2112, 128, [2112] * 5 + [1056] * 5, bf),
        ("s2spect decode step", 2, 4, 1, 2112, 128, [2112, 1056], bf),
        # phase 25's FastSpeech2 decoder self-attention: its 2048-frame
        # buffer, 2 heads of 128, the rows' valid frames (12 a token), in
        # bf16 and in float32, the model's default type
        ("FastSpeech2 decoder", 8, 2, 2048, 2048, 128, FS2_FLASH_KEYS, bf),
        ("FastSpeech2 decoder float32", 8, 2, 2048, 2048, 128, FS2_FLASH_KEYS, f32),
        # phase 26's text MT long form (B2 x 2112 tokens, the second row 1056):
        # transformer_wmt_en_de_big's encoder self-attention (16 heads of 64),
        # its decode step's encoder attention (beam 4), and the text CMLM's
        # decoder over its 256-token canvases (length beam 5); the text
        # encoder at 8 heads is "S2T encoder", the Levenshtein decoder's
        # encoder attention over its 256-token canvas "path"
        ("MT encoder", 2, 16, 2112, 2112, 64, [2112, 1056], bf),
        ("MT decode step", 8, 16, 1, 2112, 64, [2112] * 4 + [1056] * 4, bf),
        ("CMLM decoder", 10, 8, 256, 2112, 64, [2112] * 5 + [1056] * 5, bf),
        # the S2ST decoder's encoder attention in float32
        ("float32 path", 2, 8, 256, 2112, 64, [2112, 1056], f32),
        # phase 27's SEDD self-attention in long form (8 heads of 64, the
        # second row 1056 valid), in bf16 and in float32, the arch's type
        ("SEDD self-attention", 2, 8, 2112, 2112, 64, [2112, 1056], bf),
        ("SEDD self-attention float32", 2, 8, 2112, 2112, 64, [2112, 1056], f32),
        # phase 28's HuBERT / wav2vec2 encoder self-attention in long form
        # (12 heads of 64, 45 s and 32 s: 2249 and 1599 frames), in float32,
        # the models' type, and in bf16 (--dtype bfloat16)
        ("HuBERT eval long form", 2, 12, 2249, 2249, 64, [2249, 1599], bf),
        ("HuBERT eval long form float32", 2, 12, 2249, 2249, 64, [2249, 1599], f32),
        # HuBERT's self-attention over a 70 s utterance and over cli.prepare's
        # longest chunk (100 s), float32, no mask
        ("HuBERT long form", 1, 12, PREP_LONG_FRAMES, PREP_LONG_FRAMES, 64, None, f32),
        ("HuBERT longest chunk", 1, 12, PREP_CHUNK_FRAMES, PREP_CHUNK_FRAMES, 64, None, f32),
    ]
    g = torch.Generator(device="cuda").manual_seed(50)
    max_err, timed = {bf: 0.0, f32: 0.0}, {}
    for what, b, h, tq, tk, d, lengths, dtype in cases:
        q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
                   for t in (tq, tk, tk))
        mask = None if lengths is None else (
            torch.arange(tk, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])
        got = flash.flash_attention(q, k, v, mask).float()
        ref = flash.flash_attention_plain(q, k, v, mask).float()
        torch.cuda.synchronize()
        tol = FLASH_ATOL + FLASH_RTOL * ref.abs()
        if dtype == bf:
            tol = tol + torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
        err = (got - ref).abs()
        n_bad = (err > tol).sum().item()
        if not torch.isfinite(got).all() or n_bad:
            fail(f"flash_attention {what}: {n_bad} elements beyond tolerance, "
                 f"max err {err.max().item():.3e}")
        max_err[dtype] = max(max_err[dtype], err.max().item())
        print(f"kernel flash_attention {what} q [{b},{h},{tq},{d}] k/v [{b},{h},{tk},{d}] "
              f"{str(dtype)[6:]} {'no mask' if lengths is None else f'keys {lengths}'}: "
              f"max err {err.max().item():.3e}, within "
              f"rtol {FLASH_RTOL} atol {FLASH_ATOL}" + (" + 1 bf16 ulp" if dtype == bf else ""))
        if what not in ("path", "eval path", "PERFORMANCE.md", "AR decode step", "S2T encoder",
                        "UnitY decode step", "Translatotron2 decode step", "s2spect decode step",
                        "FastSpeech2 decoder", "FastSpeech2 decoder float32",
                        "MT encoder", "MT decode step", "CMLM decoder", "float32 path",
                        "HuBERT long form", "HuBERT longest chunk", "SEDD self-attention",
                        "SEDD self-attention float32", "HuBERT eval long form",
                        "HuBERT eval long form float32"):
            continue
        ms = cuda_time_ms(lambda: flash.flash_attention(q, k, v, mask))
        plain_ms = cuda_time_ms(lambda: flash.flash_attention_plain(q, k, v, mask),
                                iters=3, reps=3)
        am = None if mask is None else mask[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=am)

        library_ms = cuda_time_eager_ms(sdpa)
        backend = device_kernels(torch, sdpa)[:1]
        # the least work: each row's valid keys, the masked ones neither read
        # nor multiplied
        keys = b * tk if lengths is None else sum(lengths)
        nbytes = ((2 * q.numel() + 2 * h * keys * d) * q.element_size()
                  + (0 if mask is None else mask.numel()))
        flops = 4.0 * h * tq * keys * d
        if dtype == bf:
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            bounds = f"{flops / 1e9:.2f} GFLOP bf16"
        else:  # the lesser of the SIMT float32 bound and three tf32 passes
            simt_ms, simt_by = bound(nbytes, flops, F32_FLOP_PER_S)
            tf32_ms, tf32_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
            bound_ms, bound_by = min((simt_ms, simt_by), (tf32_ms, tf32_by))
            bounds = (f"{flops / 1e9:.2f} GFLOP float32: SIMT {simt_ms:.4f} ms, 3-pass tf32 "
                      f"{tf32_ms:.4f} ms, the {'tf32' if tf32_ms < simt_ms else 'SIMT'} one binds")
        print(f"kernel flash_attention {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {bounds}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s; "
              f"F.scaled_dot_product_attention " + ("without a mask" if mask is None else
                                                    "with the mask")
              + f" {library_ms:.4f} ms, its kernel {backend}")
        timed[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms)
    return (dict(timed["path"], max_abs_err=max_err[bf]),
            dict(timed["HuBERT long form"], max_abs_err=max_err[f32]), timed)


def check_attention_routing(torch, flash):
    """masked_attention at Tk = FLASH_MIN_LEN for shapes the kernel does not
    take (bf16 with D=80, float16), and a causal call at a shape it takes
    (the aux heads' self-attention form, which JAX keeps off its kernel):
    no flash_attention launches, and the result is the module math's, here
    held to the same function on the CPU (sum order and one rounding of the
    output's type apart: the flash tolerance plus 2 ulps)."""
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.ops.attention import FLASH_MIN_LEN, masked_attention

    g = torch.Generator(device="cuda").manual_seed(51)
    for what, dtype, d, mant, causal in (("bf16 D=80", torch.bfloat16, 80, 8, False),
                                         ("float16 D=64", torch.float16, 64, 11, False),
                                         ("bf16 D=64 causal", torch.bfloat16, 64, 8, True)):
        q, k, v = (torch.randn(2, 4, t, d, generator=g, device="cuda").to(dtype)
                   for t in (64, FLASH_MIN_LEN, FLASH_MIN_LEN))
        mask = (torch.arange(FLASH_MIN_LEN, device="cuda")[None, :]
                < torch.tensor([FLASH_MIN_LEN, 1000], device="cuda")[:, None])
        if flash.supports(q, k, v, mask) == (not causal):
            fail(f"flash_attention.supports is {not causal} for {what}")
        before = _build.launch_counts["flash_attention"]
        got = masked_attention(q, k, v, mask, causal=causal).float()
        torch.cuda.synchronize()
        if _build.launch_counts["flash_attention"] != before:
            fail(f"masked_attention {what} launched flash_attention")
        ref = masked_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu(),
                               causal=causal).float().cuda()
        ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - mant)
        err = (got - ref).abs()
        n_bad = (err > FLASH_ATOL + FLASH_RTOL * ref.abs() + 2 * ulp).sum().item()
        if got.shape != q.shape or not torch.isfinite(got).all() or n_bad:
            fail(f"masked_attention {what}: {n_bad} elements beyond tolerance of the module "
                 f"math on the CPU, max err {err.max().item():.3e}")
        print(f"attention routing {what} at Tk={FLASH_MIN_LEN}: supports() {causal}, no "
              f"flash_attention launch, module math on the card against the CPU's: max err "
              f"{err.max().item():.3e}")


def param_grads(torch, model, forward, target):
    """{name: float32 gradient} of an MSE step: sum((forward(model) - target)^2)."""
    model.zero_grad(set_to_none=True)
    ((forward(model).float() - target) ** 2).sum().backward()
    return {n: p.grad.float().clone() for n, p in model.named_parameters() if p.grad is not None}


def check_gradients(torch, mods, smi):
    """Phase 2b: parameter gradients of the denoiser's Wavenet (released
    width, 4 stacks x 8 chains, B8 x T128) and of a FiLM RMSNorm, with the
    kernels' forwards, against the plain versions' run: bf16 rows at
    GRAD_ROW_COS, float32 at GRAD_F32_REL."""
    import copy

    from diffnorm_tpu_torch.models.layers import RMSNorm
    from diffnorm_tpu_torch.models.wavenet import Wavenet
    from diffnorm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    torch.manual_seed(2)
    with torch.device("cuda"):
        modules = {"Wavenet": Wavenet(C, C, 4, 8, cond_dim=4 * C),
                   "RMSNorm": RMSNorm(C, scale=False, cond_dim=4 * C)}
    g = torch.Generator(device="cuda").manual_seed(70)
    x = torch.randn(GRAD_B, T, C, generator=g, device="cuda")
    cond = torch.randn(GRAD_B, 4 * C, generator=g, device="cuda")
    target = torch.randn(GRAD_B, T, C, generator=g, device="cuda")
    forwards = {"Wavenet": (lambda m, dt: m(x.to(dt), cond.to(dt)), "wavenet_chain"),
                "RMSNorm": (lambda m, dt: m(x.to(dt), film=m.film(cond.to(dt))),
                            "rms_norm_film")}
    for dtype in (torch.bfloat16, torch.float32):
        for name, module in modules.items():
            fwd, kernel = forwards[name]
            model = copy.deepcopy(module).to(dtype)
            _build.launch_counts.clear()
            grads = param_grads(torch, model, lambda m: fwd(m, dtype), target)
            launches = _build.launch_counts[kernel]
            with plain_versions(*mods):
                ref = param_grads(torch, model, lambda m: fwd(m, dtype), target)
            if launches == 0 or set(grads) != {n for n, _ in model.named_parameters()}:
                fail(f"gradients of {name} {dtype}: {launches} {kernel} launches, "
                     f"{len(grads)} of {len(list(model.parameters()))} parameters with a gradient")
            worst_cos, worst_rel = 1.0, 0.0
            for n, gr in grads.items():
                rr = ref[n]
                rows, ref_rows = gr.reshape(gr.shape[0], -1), rr.reshape(rr.shape[0], -1)
                if gr.dim() == 1:
                    rows, ref_rows = gr[None], rr[None]
                cos = torch.nn.functional.cosine_similarity(rows, ref_rows, dim=-1).min().item()
                rel = ((gr - rr).abs().max() / rr.abs().max()).item()
                worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
                bad = (rel > GRAD_F32_REL if dtype == torch.float32 else cos < GRAD_ROW_COS)
                if not torch.isfinite(gr).all() or bad:
                    fail(f"gradient of {name}.{n} {dtype}: row-cos {cos:.6f}, "
                         f"max-abs/scale {rel:.3e} against the plain-version run")
            print(f"gradients {name} {str(dtype)[6:]} (B{GRAD_B}xT{T}, C={C}, MSE): {len(grads)} "
                  f"parameters, {launches} {kernel} launches in the forward; against the "
                  f"plain-version run min row-cos {worst_cos:.6f}, max-abs/scale "
                  f"{worst_rel:.3e}")
    print(f"phase gradients: {time.perf_counter() - t0:.1f} s; {smi}")


def run_f32_path(torch, ddim_sample, inputs, mods, smi):
    """Phase 3c: float32 ddim_sample at the released width, 5 DDIM steps
    (stride F32_STRIDE), through the float32 kernels, with its launches, and
    the same run through the plain versions."""
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = LatentDiffusionModule().eval()

    def run():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ddim_sample(model, inputs["feature"], inputs["mask"], start_step=START_STEP,
                          stride=F32_STRIDE, enc_noise=inputs["enc"],
                          init_noise=inputs["init"], device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    run()  # warm-up
    _build.launch_counts.clear()
    (units, recon), wall = run()
    launches = dict(_build.launch_counts)
    steps = len(range(START_STEP, 0, -F32_STRIDE))
    for name, n in {"rms_norm_film": 24 * steps, "wavenet_chain": 8 * steps + 6}.items():
        if launches.get(name, 0) < n:
            fail(f"float32 path launched {name} {launches.get(name, 0)} times, expected >= {n}")
    if recon.dtype != torch.float32 or not torch.isfinite(recon).all():
        fail("float32 path: recon_feature is not finite float32")
    with plain_versions(*mods):
        (units_ref, recon_ref), wall_ref = run()
    cos = torch.nn.functional.cosine_similarity(
        recon.reshape(-1, 768), recon_ref.reshape(-1, 768), dim=-1).min().item()
    rel = ((recon - recon_ref).abs().max() / recon_ref.abs().max()).item()
    if cos < F32_PATH_ROW_COS or rel > F32_PATH_REL:
        fail(f"float32 path: recon row-cos {cos:.6f}, max-abs/scale {rel:.3e} against the "
             f"plain-version run")
    print(f"main path float32: B{B}xT{T}, {steps} DDIM steps (stride {F32_STRIDE}): wall "
          f"{wall:.4f} s, launches {launches}; plain-version run {wall_ref:.4f} s, recon "
          f"row-cos min {cos:.6f}, max-abs/scale {rel:.3e} (bounds {F32_PATH_ROW_COS}, "
          f"{F32_PATH_REL}), unit agreement {(units == units_ref).float().mean().item():.4f}; "
          f"{smi}")
    print(f"phase main path float32: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def plain_versions(norm, chain, ffpipe, fused, flash):
    """Route the models through the plain versions (the on-card reference)."""
    saved = (norm.rms_norm_film, chain.wavenet_chain, ffpipe.ffpipe_layer,
             fused.fused_layer, flash.flash_attention)
    norm.rms_norm_film, chain.wavenet_chain = norm.rms_norm_film_plain, chain.wavenet_chain_plain
    ffpipe.ffpipe_layer = lambda x, film, w, rows=1: ffpipe.ffpipe_layer_plain(x, film, w)
    fused.fused_layer = fused.fused_layer_plain
    flash.flash_attention = flash.flash_attention_plain
    try:
        yield
    finally:
        (norm.rms_norm_film, chain.wavenet_chain, ffpipe.ffpipe_layer, fused.fused_layer,
         flash.flash_attention) = saved


@contextlib.contextmanager
def plain_kernel(mod, name):
    """Route one kernel's wrapper through its plain version."""
    saved = getattr(mod, name)
    setattr(mod, name, getattr(mod, f"{name}_plain"))
    try:
        yield
    finally:
        setattr(mod, name, saved)


@contextlib.contextmanager
def float64_versions(norm, chain):
    """Route rms_norm_film and wavenet_chain through their plain versions'
    math in float64: a reference for float32 runs."""
    import torch
    import torch.nn.functional as F

    def rms_norm_film(x, film, eps=1e-12):
        xd = x.double()
        inv = torch.rsqrt(xd.square().sum(-1, keepdim=True).clamp(min=eps * eps))
        gamma, beta = film.double()[:, None, :].chunk(2, dim=-1)
        return xd * inv * math.sqrt(x.shape[-1]) * gamma + beta

    def wavenet_chain(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, dilation):
        h_in, k = x.double(), w_conv.shape[1]
        for s in range(w_conv.shape[0]):
            h = sum(F.linear(chain._shift(h_in, (k - 1 - i) * dilation), w_conv[s, i].double())
                    for i in range(k) if (k - 1 - i) * dilation < x.shape[1])
            h = h * gamma[:, s, None, :].double() + beta[:, s, None, :].double()
            h_in = (torch.tanh(h) * torch.sigmoid(h)
                    + F.linear(h_in, w_res[s].double(), b_res[s].double()))
        return F.linear(h_in, w_skip.double(), b_skip.double())

    saved = norm.rms_norm_film, chain.wavenet_chain
    norm.rms_norm_film, chain.wavenet_chain = rms_norm_film, wavenet_chain
    try:
        yield
    finally:
        norm.rms_norm_film, chain.wavenet_chain = saved


def run_main_path(torch, model, ddim_sample, inputs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    units, recon = ddim_sample(model, inputs["feature"], inputs["mask"],
                               start_step=START_STEP, enc_noise=inputs["enc"],
                               init_noise=inputs["init"], device="cuda")
    torch.cuda.synchronize()
    return units, recon, time.perf_counter() - t0


def profile_run(torch, fn, wall):
    """Device time by kernel over one more call of `fn` (torch.profiler,
    device activity only), printed with the largest kernels. The trace's raw
    events are summed here: the profiler's own tables (key_averages) build a
    Python object for every host op and kernel, which takes longer than the
    call itself at tens of thousands of kernels. Returns (the busy share of
    the unprofiled wall time, the call's device kernel launches): (None,
    None) where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}  # kernel name -> [device ns, count]
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != cuda or e.is_user_annotation() or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        entry = by_name.setdefault(e.name(), [0, 0])
        entry[0] += e.duration_ns()
        entry[1] += 1
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    n_launches = sum(n for _, n in by_name.values())
    if busy_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
        return None, None
    print(f"profile: device busy {busy_ms:.1f} ms = {100 * busy_ms / 1e3 / wall:.1f}% "
          f"of the {wall:.3f} s wall, {n_launches} device kernels; top kernels by device "
          f"time:")
    for name, (ns, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"profile:   {ns / 1e6:9.2f} ms {n:6d}x  {name[:90]}")
    return busy_ms / 1e3 / wall, n_launches


def run_cli(torch, model, smi):
    """The CLI on 8 synthetic utterances, bf16 and then --quant-int8."""
    import numpy as np

    from diffnorm_tpu_torch.cli import diff_norm_synthesis
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.weights import save_npz, to_jax_params

    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_npz(str(tmp / "params.npz"), to_jax_params(model))
        (tmp / "feat").mkdir()
        rows, lines = [], [str(tmp / "feat")]
        for i in range(8):
            n = int(rng.integers(40, 129))
            units = np.repeat(rng.integers(0, 1000, size=n), rng.integers(1, 3, size=n))
            np.save(tmp / "feat" / f"utt{i}.feat.npy",
                    rng.normal(size=(len(units), 768)).astype(np.float32))
            lines.append(f"utt{i}.feat.npy\t{len(units)}")
            rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.wav",
                         "src_n_frames": len(units),
                         "tgt_audio": " ".join(map(str, units)),
                         "tgt_n_frames": len(units)})
        (tmp / "feat" / "test.manifest.tsv").write_text("\n".join(lines) + "\n")
        write_translation_manifest(str(tmp / "test.tsv"), rows)
        for what, extra in (("bf16", []), ("int8, route fused_layer", ["--quant-int8"])):
            out_dir = tmp / f"out{len(extra)}"
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            rc = diff_norm_synthesis.main([
                str(tmp), "--params-npz", str(tmp / "params.npz"),
                "--tgt-feat-dir", str(tmp / "feat"), "--output-dir", str(out_dir),
                "--splits", "test", "--batch-size", "4", "--seed", "1", *extra])
            dt = time.perf_counter() - t0
            if rc != 0:
                fail(f"diff_norm_synthesis {' '.join(extra)} returned {rc}")
            if extra and not _build.launch_counts["fused_layer"]:
                fail("the --quant-int8 CLI run launched no fused_layer")
            out = (out_dir / "test.tsv").read_text().splitlines()[1:]
            ids = {line.split("\t")[0] for line in out}
            if ids != {r["id"] for r in rows}:
                fail(f"CLI manifest ids {sorted(ids)}")
            for line in out:
                [int(u) for u in line.split("\t")[3].split()]
            print(f"phase entry point ({what}): {dt:.2f} s for the CLI on 8 utterances "
                  f"(weights via save_npz, batch 4), manifest has every id, launches "
                  f"{dict(_build.launch_counts)}; {smi}")


def run_int8_routes(torch, qmodel, ddim_sample, inputs, units_bf16, smi, mods):
    """Phase 3b: int8 ddim_sample at full width on each kernel route, its
    launches, and the same run through the plain versions (route ffpipe2 is
    held bit for bit to route ffpipe instead). Returns each route kernel's
    launches."""
    from diffnorm_tpu_torch.ops import _build

    steps = START_STEP - 1
    transformer = qmodel.denoiser.transformer
    launches_by_kernel, runs = {}, {}
    for route, kernel in (("fused_layer", "fused_layer"), ("ffpipe", "ffpipe_layer"),
                          ("ffpipe2", "ffpipe_layer2")):
        t0 = time.perf_counter()
        transformer.int8_route = route
        ddim_sample(qmodel, inputs["feature"], inputs["mask"], start_step=START_STEP,
                    stride=START_STEP, enc_noise=inputs["enc"], init_noise=inputs["init"],
                    device="cuda")  # warm-up: one denoiser call
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        units, recon, wall = run_main_path(torch, qmodel, ddim_sample, inputs)
        launches = dict(_build.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {kernel: transformer.depth * steps, "wavenet_chain": 8 * steps + 6}
        if route != "fused_layer":
            want["rms_norm_film"] = transformer.depth * steps  # the attention norms
        for name, n in want.items():
            if launches.get(name, 0) < n:
                fail(f"int8 route {route} launched {name} {launches.get(name, 0)} times, "
                     f"expected >= {n}")
        if units.shape != (B, T) or units.min() < -4 or units.max() >= 1000:
            fail(f"int8 route {route}: units out of range")
        if recon.shape != (B, T, 768) or not torch.isfinite(recon).all():
            fail(f"int8 route {route}: recon_feature is not finite [B, T, 768]")
        runs[route] = (units, recon)
        if route == "ffpipe2":
            if not (torch.equal(units, runs["ffpipe"][0])
                    and torch.equal(recon, runs["ffpipe"][1])):
                fail("int8 route ffpipe2 differs from route ffpipe")
            against = "bit-identical to route ffpipe"
        else:
            with plain_versions(*mods):
                units_ref, recon_ref, wall_ref = run_main_path(torch, qmodel, ddim_sample, inputs)
            cos = torch.nn.functional.cosine_similarity(
                recon.float().reshape(-1, 768), recon_ref.float().reshape(-1, 768), dim=-1)
            if cos.min().item() <= PATH_ROW_COS:
                fail(f"int8 route {route}: recon row-cos {cos.min().item():.5f} "
                     f"against the plain run")
            against = (f"plain-version run {wall_ref:.4f} s, recon row-cos min "
                       f"{cos.min().item():.5f} mean {cos.mean().item():.5f}, unit agreement "
                       f"{(units == units_ref).float().mean().item():.4f}")
        print(f"main path int8 route {route}: B{B}xT{T}, {steps} DDIM steps: wall {wall:.4f} s, "
              f"RTF {B * T * SECONDS_PER_UNIT / wall:.2f}, launches {launches}, peak "
              f"{peak_gb:.2f} GB; {against}; unit agreement with the bf16 kernel path "
              f"{(units == units_bf16).float().mean().item():.4f}; {smi}")
        if route != "ffpipe2":
            profile_run(torch, lambda: run_main_path(torch, qmodel, ddim_sample, inputs),
                        wall)
        print(f"phase main path int8 {route}: {time.perf_counter() - t0:.1f} s")
        launches_by_kernel[kernel] = launches[kernel]
    return launches_by_kernel


def run_int8_static(torch, smodel, ddim_sample, inputs, units_bf16, smi, mods):
    """Phase 3d: JAX's DDIM serving headline (bench.py:38-49) on the card:
    the int8 module route with per-tensor weight and activation scales,
    int8 WaveNet convs, bf16 dequant, and static activation scales
    calibrated on the batch (start step 50, 6 points), then the 49-step run,
    its launches and profile, against the same route through the plain
    versions and against the bf16 kernel path's units."""
    from diffnorm_tpu_torch.models.diffusion import calibrate_act_scales
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.ops.quant import set_static_scales

    t0 = time.perf_counter()
    steps = START_STEP - 1
    g = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.synchronize()
    t_cal = time.perf_counter()
    n_sites = calibrate_act_scales(smodel, inputs["feature"], inputs["mask"],
                                   start_step=START_STEP, n_points=STATIC_POINTS, generator=g)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t_cal
    # 4 stacks x 8 chains x (res_conv, conv) + 8 skip_convs + 12 layers x
    # (attention, to_out, proj_in, conv, proj_out)
    if n_sites != 4 * 8 * 2 + 8 + 12 * 5:
        fail(f"int8 static: {n_sites} calibrated sites, expected {4 * 8 * 2 + 8 + 12 * 5}")
    set_static_scales(smodel)
    ddim_sample(smodel, inputs["feature"], inputs["mask"], start_step=START_STEP,
                stride=START_STEP, enc_noise=inputs["enc"], init_noise=inputs["init"],
                device="cuda")  # warm-up: one denoiser call
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    units, recon, wall = run_main_path(torch, smodel, ddim_sample, inputs)
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, n in {"rms_norm_film": 24 * steps, "wavenet_chain": 6}.items():
        if launches.get(name, 0) < n:
            fail(f"int8 static launched {name} {launches.get(name, 0)} times, expected >= {n}")
    if units.shape != (B, T) or units.min() < -4 or units.max() >= 1000:
        fail("int8 static: units out of range")
    if recon.shape != (B, T, 768) or not torch.isfinite(recon).all():
        fail("int8 static: recon_feature is not finite [B, T, 768]")
    with plain_versions(*mods):
        units_ref, recon_ref, wall_ref = run_main_path(torch, smodel, ddim_sample, inputs)
    cos = torch.nn.functional.cosine_similarity(
        recon.float().reshape(-1, 768), recon_ref.float().reshape(-1, 768), dim=-1)
    agree = (units == units_ref).float().mean().item()
    agree_bf16 = (units == units_bf16).float().mean().item()
    if cos.min().item() <= PATH_ROW_COS or agree < STATIC_UNIT_AGREE:
        fail(f"int8 static: recon row-cos {cos.min().item():.5f}, unit agreement {agree:.4f} "
             f"against the plain-version run")
    if agree_bf16 < STATIC_UNIT_AGREE:
        fail(f"int8 static: unit agreement with the bf16 kernel path {agree_bf16:.4f}")
    print(f"main path int8 static (module route, per-tensor scales, int8 WaveNet convs): "
          f"{n_sites} sites calibrated in {t_cal:.3f} s; B{B}xT{T}, {steps} DDIM steps: wall "
          f"{wall:.4f} s, RTF {B * T * SECONDS_PER_UNIT / wall:.2f}, launches {launches}, peak "
          f"{peak_gb:.2f} GB; plain-version run {wall_ref:.4f} s, recon row-cos min "
          f"{cos.min().item():.5f} mean {cos.mean().item():.5f}, unit agreement {agree:.4f}; "
          f"unit agreement with the bf16 kernel path {agree_bf16:.4f} (bound "
          f"{STATIC_UNIT_AGREE}); {smi}")
    profile_run(torch, lambda: run_main_path(torch, smodel, ddim_sample, inputs), wall)
    print(f"phase main path int8 static: {time.perf_counter() - t0:.1f} s")


def train_batches(torch, n, seed, stage, b=B, t=T):
    """n micro-batches of b x t (ragged lengths from t/2, 0-padded units),
    with every draw of the training forward injected."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(n):
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device="cuda")
        lengths[0] = t
        mask = torch.arange(t, device="cuda")[None] < lengths[:, None]
        units = torch.randint(4, 1004, (b, t), generator=g, device="cuda") * mask
        batch = {"reduce_target": torch.randn(b, t, 768, generator=g, device="cuda")
                 * mask[..., None], "reduce_target_unit": units.int(),
                 "reduce_target_lengths": lengths.int()}
        if stage == "vae":
            batch["posterior_noise"] = torch.randn(b, t, 128, generator=g, device="cuda")
        else:
            batch["inject_times"] = torch.randint(1, 200, (b,), generator=g, device="cuda")
            for key in ("enc_noise", "x1_noise", "q_noise"):
                batch[f"inject_{key}"] = torch.randn(b, t, 128, generator=g, device="cuda")
        out.append(batch)
    return out


def run_train(torch, mods, smi):
    """Phase 8: bf16 training updates of both main-path stages at the
    released widths, B64 x T128, the recipes' optimizer and schedule: the
    normalizer (update_freq 2, 3 updates) over a frozen VAE, then the VAE
    (2 updates). Each stage runs twice from one initialization on the same
    injected draws with dropout 0, through the kernels and through the
    plain versions: per update the loss within TRAIN_LOSS_REL and the
    gradient norm within TRAIN_GNORM_REL. The frozen VAE stays bit for bit;
    one more update at dropout 0.1 per stage is finite; the kernel run's
    ms per update, launches per update, peak memory and device-busy share."""
    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.criterions.vae_loss import SpeechVAELoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.models.vae import SpeechVAEModule
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    stages = {
        # name: (model, criterion, frozen, lr, update_freq, updates, kernels)
        "normalizer": (lambda dropout: LatentDiffusionModule(dropout=dropout),
                       DDPMDiscreteLoss(), ("vae",), 1e-4, 2, 3,
                       ("rms_norm_film", "wavenet_chain")),
        "VAE": (lambda dropout: SpeechVAEModule(dropout=dropout), SpeechVAELoss(), (), 5e-4,
                1, 2, ("wavenet_chain",)),
    }
    for name, (make, criterion, frozen, lr, freq, n_updates, kernels) in stages.items():
        t0 = time.perf_counter()
        stage = "vae" if name == "VAE" else "ddpm"
        micros = train_batches(torch, freq * n_updates, 80, stage)
        cfg = TrainerConfig(lr=lr, warmup_updates=10000, warmup_init_lr=1e-7,
                            adam_betas=(0.9, 0.98), clip_norm=2.0, dtype="bfloat16", seed=42)

        def build(dropout=0.0):
            torch.manual_seed(11)
            with torch.device("cuda"):
                model = make(dropout)
            return model, Trainer(cfg, model, criterion, frozen)

        runs = {}
        for version in ("kernels", "plain"):
            model, trainer = build()
            vae_before = {k: v.clone() for k, v in model.state_dict().items()
                          if k.startswith("vae.")}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            per_update = []
            with plain_versions(*mods) if version == "plain" else contextlib.nullcontext():
                for u in range(n_updates):
                    _build.launch_counts.clear()
                    t1 = time.perf_counter()
                    mets = trainer.train_step(micros[u * freq:(u + 1) * freq])
                    torch.cuda.synchronize()
                    per_update.append((mets, 1e3 * (time.perf_counter() - t1),
                                       dict(_build.launch_counts)))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            for k, v in vae_before.items():
                if not torch.equal(model.state_dict()[k], v):
                    fail(f"train {name}: the frozen VAE parameter {k} moved")
            runs[version] = (per_update, peak_gb)
            if version == "kernels":
                for _, _, launches in per_update:
                    if any(launches.get(k, 0) == 0 for k in kernels):
                        fail(f"train {name}: an update launched {launches}, expected {kernels}")
                wall = statistics.median(ms for _, ms, _ in per_update[1:]) / 1e3
                profile_run(torch, lambda: trainer.train_step(micros[:freq]), wall)
            del model, trainer
        worst_loss = worst_gnorm = 0.0
        for (mk, _, _), (mp, _, _) in zip(runs["kernels"][0], runs["plain"][0]):
            if not (math.isfinite(mk["loss"]) and math.isfinite(mk["gnorm"])):
                fail(f"train {name}: non-finite loss or gradient norm {mk}")
            worst_loss = max(worst_loss, abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]))
            worst_gnorm = max(worst_gnorm, abs(mk["gnorm"] - mp["gnorm"]) / abs(mp["gnorm"]))
        if worst_loss > TRAIN_LOSS_REL or worst_gnorm > TRAIN_GNORM_REL:
            fail(f"train {name}: kernels against plain versions, loss rel {worst_loss:.3e}, "
                 f"gnorm rel {worst_gnorm:.3e}")
        model, trainer = build(dropout=0.1)
        mets = trainer.train_step(micros[:freq])
        if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
            fail(f"train {name}: dropout 0.1 gave {mets}")
        del model, trainer
        per_update, peak_gb = runs["kernels"]
        plain_ms = [round(ms, 1) for _, ms, _ in runs["plain"][0]]
        print(f"train {name}: B{B}xT{T} x update_freq {freq}, bf16 forward, float32 masters; "
              f"losses {[round(m['loss'], 5) for m, _, _ in per_update]}, gnorms "
              f"{[round(m['gnorm'], 4) for m, _, _ in per_update]}; ms per update "
              f"{[round(ms, 1) for _, ms, _ in per_update]} (plain versions {plain_ms}); "
              f"launches per update {per_update[-1][2]}; peak {peak_gb:.2f} GB; against the "
              f"plain-version run loss rel {worst_loss:.2e} (bound {TRAIN_LOSS_REL}), gnorm rel "
              f"{worst_gnorm:.2e} (bound {TRAIN_GNORM_REL}); frozen VAE bit-identical; "
              f"dropout 0.1 update loss {mets['loss']:.5f}; {smi}")
        print(f"phase train {name}: {time.perf_counter() - t0:.1f} s")


def write_train_corpus(root: Path, seed: int = 4):
    """A small corpus in the layout ReprToReprUnitDataset reads: train (24)
    and dev (4) utterances of 40-128 units with 768-d features."""
    import numpy as np

    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(seed)
    feat_dir = root / "feat"
    feat_dir.mkdir()
    for split, n in (("train", 24), ("dev", 4), ("test", 4)):
        rows, lines = [], [str(feat_dir)]
        for i in range(n):
            units = rng.integers(0, 1000, size=int(rng.integers(40, 129)))
            name = f"{split}{i}"
            np.save(feat_dir / f"{name}.feat.npy",
                    rng.normal(size=(len(units), 768)).astype(np.float32))
            lines.append(f"{name}.feat.npy\t{len(units)}")
            rows.append({"id": name, "src_audio": f"{name}.wav", "src_n_frames": len(units),
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        (feat_dir / f"{split}.manifest.tsv").write_text("\n".join(lines) + "\n")
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    return feat_dir


def run_train_cli(torch, smi):
    """Phase 9: cli.train at the released widths (CLI_NORMALIZER's depth) in
    bf16 on a small corpus: the VAE for 2 updates and a checkpoint, the
    normalizer over it (--speech-decoder-ckpt) for 2 updates and a
    checkpoint, resumed to 4, then cli.diff_norm_synthesis --params-npz on
    the trained normalizer."""
    from diffnorm_tpu_torch.cli import diff_norm_synthesis
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.ops import _build

    lines = LogLines()
    logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        feat_dir = write_train_corpus(tmp)
        common = [str(tmp), "--tgt-feat-dir", str(feat_dir), "--target-code-size", "1000",
                  "--dropout", "0.1", "--keep-best-checkpoints", "5",
                  "--best-checkpoint-metric", "loss", "--keep-last-epochs", "5",
                  "--lr-scheduler", "inverse_sqrt", "--warmup-init-lr", "1e-7",
                  "--warmup-updates", "10000", "--adam-betas", "(0.9,0.98)", "--clip-norm",
                  "2.0", "--max-tokens", "1200", "--max-target-positions", "2048", "--seed",
                  "42", "--prng-impl", "rbg", "--log-interval", "1", "--dtype", "bfloat16",
                  *normalizer_flags(CLI_NORMALIZER)]
        vae_dir, diff_dir = tmp / "vae", tmp / "diff"
        runs = [
            ("VAE", ["--task", "speech_decoder", "--criterion", "speech_vae_decoder_loss",
                     "--arch", "speech_vae_decoder", "--latent-dim", "128", "--lr", "5e-4",
                     "--save-dir", str(vae_dir), "--max-update", "2"], 2),
            ("normalizer", ["--task", "speech_diffusion_discrete", "--criterion",
                            "ddpm_discrete_loss", "--arch", "diff_discrete", "--latent-dim",
                            "128", "--multitask", "true", "--lr", "1e-4",
                            "--speech-decoder-ckpt", str(vae_dir / "step_000000002"),
                            "--validate-interval", "1", "--save-interval", "1",
                            "--save-dir", str(diff_dir), "--max-update", "2"], 2),
        ]
        runs.append(("normalizer, resumed", runs[1][1][:-1] + ["4"], 4))
        for what, extra, want_step in runs:
            lines.lines.clear()
            _build.launch_counts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if train_cli.main(common + extra) != 0:
                fail(f"cli.train {what} failed")
            dt = time.perf_counter() - t0
            need = [f"saved checkpoint at step {want_step}", "valid |", "| step"]
            if what.endswith("resumed"):
                need.append("resumed from step 2")
            log = "\n".join(lines.lines)
            missing = [n for n in need if n not in log]
            if missing or not _build.launch_counts["wavenet_chain"]:
                fail(f"cli.train {what}: log lacks {missing}, launches "
                     f"{dict(_build.launch_counts)}")
            print(f"phase entry point train ({what}): {dt:.2f} s for cli.train to step "
                  f"{want_step} (released widths, depth {CLI_NORMALIZER}, bf16, 24 "
                  f"utterances), launches "
                  f"{dict(_build.launch_counts)}; {smi}")
        logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
        out_dir = tmp / "normalized"
        t0 = time.perf_counter()
        rc = diff_norm_synthesis.main([
            str(tmp), "--params-npz", str(diff_dir / "step_000000004" / "params.npz"),
            "--tgt-feat-dir", str(feat_dir), "--output-dir", str(out_dir), "--splits", "test",
            "--batch-size", "4", *normalizer_flags(CLI_NORMALIZER)])
        out = (out_dir / "test.tsv").read_text().splitlines()[1:] if rc == 0 else []
        if len(out) != 4:
            fail(f"diff_norm_synthesis on the trained normalizer: rc {rc}, {len(out)} rows")
        print(f"phase entry point train (synthesis): {time.perf_counter() - t0:.2f} s for "
              f"cli.diff_norm_synthesis --params-npz on the trained normalizer, 4 rows; {smi}")


def nar_batch(rng, src_lengths, tgt_units):
    """A collated NAR batch: normal fbank [B, bucket(T), 80] zero past each
    length, unit targets (+ EOS, pad 1) [B, bucket(L)] and their
    random-mask canvas."""
    import numpy as np

    from diffnorm_tpu_torch.data.batching import bucket_length
    from diffnorm_tpu_torch.tasks.nar_s2ut_task import random_mask

    src_lengths = np.asarray(src_lengths, np.int32)
    t = bucket_length(int(src_lengths.max()))
    mask = np.arange(t)[None, :] < src_lengths[:, None]
    src = (rng.normal(size=(len(src_lengths), t, 80)) * mask[..., None]).astype(np.float32)
    target = np.full((len(src_lengths), bucket_length(max(tgt_units) + 1)), 1, np.int32)
    for i, n in enumerate(tgt_units):
        target[i, :n] = rng.integers(4, 1004, size=n)
        target[i, n] = 2
    return {"src_tokens": src, "src_lengths": src_lengths, "target": target,
            "prev_target": random_mask(target, rng)}


def run_train_nar(torch, mods, smi):
    """Phase 10: NAR S2UT training at the released widths (see the module
    docstring)."""
    import numpy as np

    from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    rng = np.random.default_rng(90)
    hi = NAR_MAX_TOKENS // NAR_B
    cvss = [nar_batch(rng, np.sort(rng.integers(300, hi + 1, NAR_B))[::-1],
                      rng.integers(100, 251, NAR_B).tolist()) for _ in range(NAR_UPDATES + 1)]

    def build(**kw):
        torch.manual_seed(12)
        with torch.device("cuda"):
            model = NARS2UTModule(**kw)
        return model, Trainer(TrainerConfig(**NAR_TRAIN), model, NARSpeechToUnitLoss(0.2))

    model, trainer = build()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    per_update = []
    for u in range(NAR_UPDATES + 1):
        if u == NAR_UPDATES:
            trainer.model.cg_prob = 0.15
        t1 = time.perf_counter()
        mets = trainer.train_step([cvss[u]])
        torch.cuda.synchronize()
        per_update.append((mets, 1e3 * (time.perf_counter() - t1)))
        if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
            fail(f"train NAR: update {u} gave {mets}")
    n_flash = _build.launch_counts.get("flash_attention", 0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if n_flash:
        fail(f"train NAR: flash_attention launched {n_flash} times at CVSS length")
    wall = statistics.median(ms for _, ms in per_update[1:NAR_UPDATES]) / 1e3
    frames = int(cvss[0]["src_lengths"].sum())
    print(f"train NAR, CVSS-shaped: {n_params / 1e6:.1f}M parameters, B{NAR_B} x "
          f"{cvss[0]['src_tokens'].shape[1]} padded frames ({frames} real, longest "
          f"{int(cvss[0]['src_lengths'].max())}), targets {cvss[0]['target'].shape[1]} padded "
          f"({int((cvss[0]['target'] != 1).sum())} tokens), bf16 forward, float32 masters; losses "
          f"{[round(m['loss'], 5) for m, _ in per_update]}, gnorms "
          f"{[round(m['gnorm'], 4) for m, _ in per_update]} (the last at cg_prob 0.15); ms "
          f"per update {[round(ms, 1) for _, ms in per_update]}; peak {peak_gb:.2f} GB; "
          f"flash_attention launches {n_flash}; {smi}")
    profile_run(torch, lambda: trainer.train_step([cvss[1]]), wall)
    del model, trainer

    # long form: the decoder's encoder attention over S = 2112 keys
    long = nar_batch(rng, [LONG_FRAMES, LONG_FRAMES // 2], [600, 300])
    runs = {}
    for version in ("kernels", "plain"):
        model, trainer = build(attention_dropout=0.0)
        with plain_versions(*mods) if version == "plain" else contextlib.nullcontext():
            # warm-up: a validation forward draws nothing and leaves the
            # statistics alone, so both runs still start alike
            trainer.valid_step(long, torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            t1 = time.perf_counter()
            mets = trainer.train_step([long])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
            train_flash = _build.launch_counts.get("flash_attention", 0)
            _build.launch_counts.clear()
            valid = trainer.valid_step(long, torch.Generator(device="cuda").manual_seed(0))
            valid_flash = _build.launch_counts.get("flash_attention", 0)
        runs[version] = (mets, valid, ms, train_flash, valid_flash)
        del model, trainer
    (mk, vk, ms_k, flash_train, flash_valid), (mp, vp, ms_p, _, _) = runs["kernels"], runs["plain"]
    layers = 6
    if flash_train != layers or flash_valid != layers:
        fail(f"train NAR long form: flash_attention launched {flash_train} times in the "
             f"training forward and {flash_valid} in validation, expected {layers} each")
    loss_rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    gnorm_rel = abs(mk["gnorm"] - mp["gnorm"]) / abs(mp["gnorm"])
    valid_rel = abs(vk["loss"] - vp["loss"]) / abs(vp["loss"])
    if not all(math.isfinite(v) for v in (mk["loss"], mk["gnorm"], vk["loss"])):
        fail(f"train NAR long form: non-finite {mk} / {vk}")
    if loss_rel > TRAIN_LOSS_REL or gnorm_rel > TRAIN_GNORM_REL or valid_rel > TRAIN_LOSS_REL:
        fail(f"train NAR long form: kernels against plain versions, loss rel {loss_rel:.3e}, "
             f"gnorm rel {gnorm_rel:.3e}, valid loss rel {valid_rel:.3e}")
    print(f"train NAR, long form: B2 x {LONG_FRAMES} frames (S = 2112, the last row half), "
          f"600 / 300 units, --attention-dropout 0: update {ms_k:.1f} ms (plain versions "
          f"{ms_p:.1f} ms), loss {mk['loss']:.5f}, gnorm {mk['gnorm']:.4f}; against the "
          f"plain-version run loss rel {loss_rel:.2e} (bound {TRAIN_LOSS_REL}), gnorm rel "
          f"{gnorm_rel:.2e} (bound {TRAIN_GNORM_REL}), valid loss {vk['loss']:.5f} rel "
          f"{valid_rel:.2e}; flash_attention launches per forward: training {flash_train}, "
          f"validation {flash_valid}; {smi}")
    print(f"phase train NAR: {time.perf_counter() - t0:.1f} s")


def write_nar_corpus(root: Path, seed: int = 5):
    """train (24), dev (4) and test (4) splits of 3-7 s 16 kHz WAV sources
    (written with `wave`) and 40-200 unit targets, and a config.yaml with
    utterance CMVN and SpecAugment on _train."""
    import wave

    import numpy as np

    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(seed)
    seconds = 0.0
    for split, n in (("train", 24), ("dev", 4), ("test", 4)):
        rows = []
        for i in range(n):
            pcm = (rng.normal(size=int(rng.uniform(3.0, 7.0) * 16000)) * 3000).astype(np.int16)
            with wave.open(str(root / f"{split}{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.tobytes())
            if split == "test":
                seconds += len(pcm) / 16000
            units = rng.integers(0, 1000, size=int(rng.integers(40, 201)))
            rows.append({"id": f"{split}{i}", "src_audio": f"{split}{i}.wav",
                         "src_n_frames": (len(pcm) - 400) // 160 + 1,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(
        "transforms:\n  '*': [utterance_cmvn]\n  _train: [specaugment]\n"
        "specaugment:\n  freq_mask_N: 2\n  freq_mask_F: 27\n  time_mask_N: 2\n"
        "  time_mask_T: 100\n  time_mask_p: 1.0\n")
    return seconds


def run_train_nar_cli(torch, smi):
    """Phase 11: cli.train on WAV sources at the released widths in bf16 (2
    updates and a checkpoint, resumed to 4), then cli.s2st --params-npz on
    the step directory."""
    from diffnorm_tpu_torch.cli import s2st as s2st_cli
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        test_seconds = write_nar_corpus(tmp)
        save_dir = tmp / "nar"
        args = [str(tmp), "--config-yaml", "config.yaml", "--cg-prob", "0.0", "--task",
                "speech_to_speech_fasttranslate", "--target-code-size", "1000", "--criterion",
                "nar_speech_to_unit", "--label-smoothing", "0.2", "--arch",
                "nar_s2ut_conformer", "--dropout", "0.1", "--train-subset", "train",
                "--valid-subset", "dev", "--save-dir", str(save_dir),
                "--keep-best-checkpoints", "5", "--best-checkpoint-metric", "loss",
                "--keep-last-epochs", "5", "--lr", "5e-4", "--lr-scheduler", "inverse_sqrt",
                "--warmup-init-lr", "1e-7", "--warmup-updates", "10000", "--adam-betas",
                "(0.9,0.98)", "--clip-norm", "10.0", "--max-update", "2", "--max-tokens",
                "8000", "--max-target-positions", "1024", "--seed", "42", "--prng-impl", "rbg",
                "--validate-interval", "5", "--save-interval", "5", "--dtype", "bfloat16",
                "--log-interval", "1"]
        lines = LogLines()
        logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
        for what, max_update in (("2 updates", 2), ("resumed to 4", 4)):
            lines.lines.clear()
            i = args.index("--max-update") + 1
            args[i] = str(max_update)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if train_cli.main(args) != 0:
                fail(f"cli.train NAR ({what}) failed")
            dt = time.perf_counter() - t0
            log = "\n".join(lines.lines)
            need = [f"saved checkpoint at step {max_update}", "valid |", "| step"]
            if max_update == 4:
                need.append("resumed from step 2")
            missing = [n for n in need if n not in log]
            if missing:
                fail(f"cli.train NAR ({what}): log lacks {missing}")
            steps = [line for line in lines.lines if "| step" in line]
            print(f"phase entry point train NAR ({what}): {dt:.2f} s for cli.train (released "
                  f"widths, bf16, 24 WAV utterances of 3-7 s through the fbank front end); "
                  f"last step: {steps[-1]}; {smi}")
        logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
        torch.manual_seed(3)
        voc = CodeHiFiGANVocoder.from_config(VOCODER_CFG, device="cuda")
        save_npz(str(tmp / "voc.npz"), to_jax_variables(voc.module))
        (tmp / "voc.json").write_text(json.dumps(VOCODER_CFG))
        del voc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = s2st_cli.main([str(tmp), "--params-npz", str(save_dir / "step_000000004"),
                            "--vocoder-npz", str(tmp / "voc.npz"),
                            "--vocoder-cfg", str(tmp / "voc.json"),
                            "--results-path", str(tmp / "out"), "--batch-size", "4",
                            "--dur-prediction", "--max-duration", "4"])
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"cli.s2st on the trained NAR checkpoint returned {rc}")
        lines = (tmp / "out" / "s2st-test.unit").read_text().splitlines()
        if sorted(line.split("|")[0] for line in lines) != [f"test{i}" for i in range(4)]:
            fail(f"cli.s2st on the trained checkpoint: unit file {lines}")
        print(f"phase entry point train NAR (cli.s2st): {dt:.2f} s for cli.s2st --params-npz "
              f"<step directory> on 4 WAV utterances ({test_seconds:.1f} s of speech, RTF "
              f"{test_seconds / dt:.2f} with the models' load), every {{id}}_pred.wav "
              f"written; {smi}")


def s2st_models(torch):
    """The released nar_s2ut_conformer and code-HiFi-GAN (with its duration
    predictor), seeded random init in bf16. The specials' rows of the shared
    embedding (their output columns) are zeroed and the unit rows scaled by
    10, as tests/test_cli_s2st.py does, so the decode emits varied units."""
    from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder

    nar = seeded_nar(torch, 0)
    voc = CodeHiFiGANVocoder.from_config(VOCODER_CFG, device="cuda", dtype=torch.bfloat16)
    return nar, voc.module


def seeded_nar(torch, seed: int, dtype=None):
    """The released nar_s2ut_conformer from `seed`, the specials' rows of
    its shared embedding zeroed and the unit rows scaled by 10; bf16 (or
    `dtype`)."""
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule

    torch.manual_seed(seed)
    with torch.device("cuda"):
        nar = NARS2UTModule()
    with torch.no_grad():
        emb = nar.decoder.embed_tokens.weight
        emb[:4] = 0.0
        emb[4:] *= 10.0
    return nar.to(dtype or torch.bfloat16).eval()


def s2st_inputs(torch, b, frames, seed=0):
    """bench.py --e2e's batch: normal fbank [B, frames, 80], every row full
    length but the last, which has half."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = np.full((b,), frames, np.int32)
    lengths[-1] = max(frames // 2, 9)
    return (torch.from_numpy(rng.normal(size=(b, frames, 80)).astype(np.float32)).cuda(),
            torch.from_numpy(lengths).cuda())


def run_s2st(torch, s2st_generate, nar, voc, inputs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = s2st_generate(nar, voc, *inputs, **S2ST_KW)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def s2st_phase(torch, what, s2st_generate, nar, voc, inputs, mods, smi, long_form):
    """s2st_generate through the kernels (warm-up, then a run with the
    counts set to 0 just before it and read just after), the same run
    through the plain versions, and the checks. Returns the launches, the
    reduced units and their counts, and the median wall."""
    from diffnorm_tpu_torch.models.conformer import subsampled_lengths
    from diffnorm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    b, frames = inputs[0].shape[:2]
    run_s2st(torch, s2st_generate, nar, voc, inputs)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    (wav, wav_lengths, units, counts, steps), wall = run_s2st(
        torch, s2st_generate, nar, voc, inputs)
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the chain is host-bound and one run's wall moves by tens of percent:
    # the median of S2ST_REPS runs
    walls = [wall] + [run_s2st(torch, s2st_generate, nar, voc, inputs)[1]
                      for _ in range(S2ST_REPS - 1)]
    wall = statistics.median(walls)
    forwards = int(steps.max())  # one decoder forward per iteration (no CG)
    n_flash = launches.get("flash_attention", 0)
    if long_form and n_flash < nar.decoder.n_layers * forwards:
        fail(f"S2ST {what}: flash_attention launched {n_flash} times for {forwards} "
             f"decoder forwards of {nar.decoder.n_layers} layers")
    if not long_form and n_flash:
        fail(f"S2ST {what}: flash_attention launched at a source below 2048 frames")
    n_wav = S2ST_KW["max_wav_units"] * voc.upsample
    if wav.shape != (b, n_wav) or not torch.isfinite(wav.float()).all():
        fail(f"S2ST {what}: waveform is not finite [{b}, {n_wav}]")
    if counts.max() < 1 or units.min() < 0 or units.max() >= 1000:
        fail(f"S2ST {what}: no units, or units out of range (counts {counts.tolist()})")
    with plain_versions(*mods):
        (wav_ref, _, units_ref, counts_ref, _), wall_ref = run_s2st(
            torch, s2st_generate, nar, voc, inputs)
    shared = torch.minimum(counts, counts_ref)
    valid = torch.arange(units.shape[1], device=units.device)[None, :] < shared[:, None]
    agree = ((units == units_ref) & valid).sum().item() / max(valid.sum().item(), 1)
    same = agree == 1.0 and torch.equal(counts, counts_ref)
    cos = torch.nn.functional.cosine_similarity(wav.float(), wav_ref.float(), dim=-1)
    rel = ((wav.float() - wav_ref.float()).abs().max() / wav_ref.float().abs().max()).item()
    against = (f"plain-version run {wall_ref:.4f} s, units {'equal' if same else 'differ'} "
               f"(share equal {agree:.4f}; counts {counts_ref.tolist()}), waveform row-cos "
               f"min {cos.min().item():.6f} mean {cos.mean().item():.6f}, max-abs/scale "
               f"{rel:.3e}")
    if long_form:
        against += "; " + decoder_check(torch, nar, inputs, mods, what)
        if agree < LONG_UNIT_AGREE or cos.min().item() < LONG_WAV_ROW_COS:
            fail(f"S2ST {what}: against the plain-version run, {against}")
    elif not same or cos.min().item() < S2ST_WAV_ROW_COS:
        fail(f"S2ST {what}: the plain-version run differs ({against})")
    audio_s = b * frames * SECONDS_PER_FRAME
    n_sub = int(subsampled_lengths(torch.tensor([frames]))[0])
    print(f"S2ST {what}: B{b}x{frames} frames ({frames * SECONDS_PER_FRAME:.1f} s, "
          f"{n_sub} subsampled), bf16: wall {wall:.4f} s (median of {len(walls)} runs, "
          f"{min(walls):.4f}-{max(walls):.4f} s), RTF {audio_s / wall:.2f}, "
          f"iterations per row {steps.tolist()}, decoder forwards {forwards}, launches {launches} (flash_attention {n_flash}), peak {peak_gb:.2f} GB, "
          f"unit counts {counts.tolist()}; {against}; {smi}")
    print(f"S2ST {what} by stage: {s2st_stages(torch, nar, voc, inputs)}")
    if not long_form:
        profile_run(torch, lambda: run_s2st(torch, s2st_generate, nar, voc, inputs), wall)
    print(f"phase S2ST {what}: {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, units=units, counts=counts, wall=wall)


def s2st_stages(torch, nar, voc, inputs):
    """Wall of the chain's stages, each alone between synchronizations: the
    encoder, the mask-predict decode (encoder included) and the vocoder on a
    full canvas of random units."""
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.generate.s2st import _chunked_vocoder

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(61)
    codes = torch.randint(0, 1000, (inputs[0].shape[0], S2ST_KW["max_wav_units"]),
                          generator=g, device="cuda")
    kw = {k: S2ST_KW[k] for k in ("max_iter", "max_len")}
    with torch.no_grad():
        enc = timed(lambda: nar.encode(*inputs))
        dec = timed(lambda: mask_predict_decode(nar, *inputs, **kw))
        vocoder = timed(lambda: _chunked_vocoder(voc, codes, S2ST_KW["vocoder_chunk"]))
    return (f"encoder {enc:.4f} s, mask-predict decode with the encoder {dec:.4f} s, "
            f"vocoder on the full {S2ST_KW['max_wav_units']}-unit canvas {vocoder:.4f} s")


def decoder_check(torch, nar, inputs, mods, what):
    """One decoder forward over a fixed random canvas of 256 units on the
    encoder output, through the kernels and through the plain versions:
    logits row-cos, argmax agreement, max-abs over scale. Checked against
    the LONG_* bounds; returns the line to print."""
    g = torch.Generator(device="cuda").manual_seed(60)
    with torch.no_grad():
        enc, enc_mask = nar.encode(*inputs)
        tokens = torch.randint(4, nar.vocab_size, (enc.shape[0], S2ST_KW["max_len"]),
                               generator=g, device="cuda")
        logits = nar.decode(tokens, enc, enc_mask).float()
        with plain_versions(*mods):
            ref = nar.decode(tokens, enc, enc_mask).float()
    cos = torch.nn.functional.cosine_similarity(logits, ref, dim=-1).min().item()
    argmax = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    line = (f"one decoder forward on a fixed canvas: logits row-cos min {cos:.6f}, argmax "
            f"agreement {argmax:.4f}, max-abs/scale {rel:.3e}")
    if cos < LONG_LOGIT_ROW_COS or argmax < LONG_ARGMAX_AGREE:
        fail(f"S2ST {what}: {line}")
    return line


def run_s2st_cli(torch, nar, voc, smi):
    """cli.s2st on 8 synthetic .npy utterances, both models via save_npz."""
    import wave

    import numpy as np

    from diffnorm_tpu_torch.cli import s2st as s2st_cli
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    rng = np.random.default_rng(4)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_npz(str(tmp / "nar.npz"), to_jax_variables(nar))
        save_npz(str(tmp / "voc.npz"), to_jax_variables(voc))
        (tmp / "voc.json").write_text(json.dumps(VOCODER_CFG))
        rows = []
        for i in range(8):
            n = int(rng.integers(300, 701))
            np.save(tmp / f"utt{i}.npy", rng.normal(size=(n, 80)).astype(np.float32))
            rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.npy", "src_n_frames": n,
                         "tgt_audio": "0", "tgt_n_frames": 1})
        write_translation_manifest(str(tmp / "test.tsv"), rows)
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        rc = s2st_cli.main([str(tmp), "--params-npz", str(tmp / "nar.npz"),
                            "--vocoder-npz", str(tmp / "voc.npz"),
                            "--vocoder-cfg", str(tmp / "voc.json"),
                            "--results-path", str(tmp / "out"), "--batch-size", "4",
                            "--dur-prediction", "--max-duration", "4"])
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"cli.s2st returned {rc}")
        lines = (tmp / "out" / "s2st-test.unit").read_text().splitlines()
        ids = [line.split("|")[0] for line in lines]
        if sorted(ids) != sorted(r["id"] for r in rows):
            fail(f"cli.s2st unit file ids {ids}")
        for uid in ids:
            with wave.open(str(tmp / "out" / f"{uid}_pred.wav")) as w:
                if w.getnframes() <= 0 or w.getframerate() != 16000:
                    fail(f"cli.s2st wrote an empty or mis-rated {uid}_pred.wav")
        n_units = sum(len(line.split("|")[1].split()) for line in lines)
        print(f"phase entry point S2ST: {dt:.2f} s for cli.s2st on 8 utterances (300-700 "
              f"frames, batch 4, --dur-prediction, weights via save_npz): every "
              f"{{id}}_pred.wav written, unit file has every id ({n_units} units), launches "
              f"{dict(_build.launch_counts)}; {smi}")


def s2st_int8_model(torch, nar):
    """The released nar_s2ut_conformer of `s2st_models` with quant_int8
    (JAX's default knobs), from the same seeded init (the int8 packs draw
    nothing): its int8 weights are packed from the float32 masters before
    the cast to bf16. Fails unless its float weights equal `nar`'s."""
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule

    torch.manual_seed(0)
    with torch.device("cuda"):
        qnar = NARS2UTModule(quant_int8=True)
    with torch.no_grad():
        emb = qnar.decoder.embed_tokens.weight
        emb[:4] = 0.0
        emb[4:] *= 10.0
    qnar = qnar.to(torch.bfloat16).eval()
    want = nar.state_dict()
    if qnar.state_dict().keys() != want.keys() or not all(
            torch.equal(t, want[k]) for k, t in qnar.state_dict().items()):
        fail("S2ST int8: the int8 model's weights differ from the bf16 model's")
    return qnar


def calibration_target(torch, b, frames, seed=62):
    """A seeded unit target per row (dictionary ids 4-1003, EOS last, PAD
    after), one unit per subsampled source frame, as the canvas of the
    first batch that calibration runs on (cli/generate.py:_calibrate_static)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = frames // 4
    tgt = np.full((b, n + 1), 1, np.int64)
    for row in range(b):
        m = n if row < b - 1 else n // 2
        tgt[row, :m] = rng.integers(4, 1004, size=m)
        tgt[row, m] = 2
    return torch.from_numpy(tgt).cuda()


def run_s2st_int8(torch, s2st_generate, nar, voc, bf16, mods, smi):
    """Phase 16: bench.py --e2e's default, the int8 NAR decode with static
    scales calibrated on the first batch's canvas (156 sites), the vocoder in
    bf16, at CVSS length (B16 x 480) beside phase 5's bf16 chain, then in
    long form (B2 x 8448, flash_attention in the decoder's encoder attention)
    against the plain versions. Returns the long form's flash_attention
    launches."""
    from diffnorm_tpu_torch.models.nar_transformer import calibrate_act_scales
    from diffnorm_tpu_torch.ops.quant import set_static_scales

    t0 = time.perf_counter()
    qnar = s2st_int8_model(torch, nar)
    inputs = s2st_inputs(torch, S2ST_B, S2ST_FRAMES)
    torch.cuda.synchronize()
    t_cal = time.perf_counter()
    n_sites = calibrate_act_scales(qnar, *inputs,
                                   calibration_target(torch, S2ST_B, S2ST_FRAMES))
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t_cal
    if n_sites != S2ST_INT8_SITES:
        fail(f"S2ST int8: {n_sites} calibrated sites, expected {S2ST_INT8_SITES}")
    set_static_scales(qnar)
    int8 = s2st_phase(torch, "int8 static CVSS length", s2st_generate, qnar, voc, inputs,
                      mods, smi, long_form=False)
    units, counts = int8["units"], int8["counts"]
    shared = torch.minimum(counts, bf16["counts"])
    valid = torch.arange(units.shape[1], device=units.device)[None, :] < shared[:, None]
    agree = ((units == bf16["units"]) & valid).sum().item() / max(valid.sum().item(), 1)
    audio_s = S2ST_B * S2ST_FRAMES * SECONDS_PER_FRAME
    line = (f"S2ST int8 static (bench.py --e2e's default): {n_sites} sites calibrated in "
            f"{t_cal:.3f} s on the first batch's canvas; CVSS length wall {int8['wall']:.4f} s "
            f"(RTF {audio_s / int8['wall']:.2f}) against the bf16 chain's {bf16['wall']:.4f} s "
            f"(RTF {audio_s / bf16['wall']:.2f}) of phase 5; reduced units equal to the bf16 "
            f"decode's in {agree:.4f} of positions (bound {S2ST_INT8_UNIT_AGREE}), unit counts "
            f"{counts.tolist()} against {bf16['counts'].tolist()}; {smi}")
    g = torch.Generator(device="cuda").manual_seed(60)
    with torch.no_grad():
        tokens = torch.randint(4, nar.vocab_size, (S2ST_B, S2ST_KW["max_len"]), generator=g,
                               device="cuda")
        ref = nar.decode(tokens, *nar.encode(*inputs)).float()
        logits = qnar.decode(tokens, *qnar.encode(*inputs)).float()
    cos = torch.nn.functional.cosine_similarity(logits, ref, dim=-1).min().item()
    argmax = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    line += (f"; the encoder and one decoder forward over a fixed canvas against bf16: "
             f"logits row-cos min {cos:.6f} (bound {S2ST_INT8_LOGIT_ROW_COS}), argmax agreement "
             f"{argmax:.4f} (bound {S2ST_INT8_ARGMAX_AGREE})")
    if (agree < S2ST_INT8_UNIT_AGREE or cos < S2ST_INT8_LOGIT_ROW_COS
            or argmax < S2ST_INT8_ARGMAX_AGREE):
        fail(line)
    print(line)
    long_form = s2st_phase(torch, "int8 static long form", s2st_generate, qnar, voc,
                           s2st_inputs(torch, LONG_B, LONG_FRAMES), mods, smi, long_form=True)
    print(f"phase S2ST int8 static: {time.perf_counter() - t0:.1f} s")
    return long_form["launches"].get("flash_attention", 0)


def prep_models(torch):
    """mHuBERT-base (768 x 12 heads, FFN 3072, 12 layers, the released conv
    extractor) from a seeded init, float32, and its bf16 copy."""
    from diffnorm_tpu_torch.models.hubert import HubertEncoder

    torch.manual_seed(20)
    with torch.device("cuda"):
        model, bf16 = HubertEncoder().eval(), HubertEncoder()
    bf16.load_state_dict(model.state_dict())
    return model, bf16.to(torch.bfloat16).eval()


def fitted_codebook(torch, feats):
    """A seeded K=1000 codebook fitted to [N, 768] features (kmeans_fit on the
    card, 10 iterations): a random-init encoder's frames differ by a few
    percent of their norm, so a random codebook would give one unit."""
    from diffnorm_tpu_torch.models.kmeans import kmeans_fit

    cent = kmeans_fit(feats.float().cpu().numpy(), PREP_K, iters=10, seed=0, device="cuda")
    return torch.from_numpy(cent).cuda()


def run_prep_bench(torch, model, bf16, smi):
    """Phase 12: bench.py --prepare's program in the port's eager form."""
    from diffnorm_tpu_torch.models.hubert import frames_for_samples
    from diffnorm_tpu_torch.models.kmeans import kmeans_predict

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(21)
    wav = 0.1 * torch.randn(PREP_B, PREP_SAMPLES, generator=g, device="cuda")
    n = frames_for_samples(PREP_SAMPLES)

    @torch.no_grad()
    def features(m):
        return m(wav, output_layer=PREP_LAYER).float()

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    feats32 = features(model)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t1
    cent = fitted_codebook(torch, feats32.reshape(-1, 768))

    @torch.no_grad()
    def step():
        feats = features(bf16)
        return feats, kmeans_predict(feats, cent)

    step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(PREP_REPS):
        t1 = time.perf_counter()
        feats, units = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall, peak_gb = statistics.median(walls), torch.cuda.max_memory_allocated() / 1e9
    if feats.shape != (PREP_B, n, 768) or not torch.isfinite(feats).all():
        fail(f"prep bench: features {tuple(feats.shape)}, expected finite [{PREP_B}, {n}, 768]")
    if units.shape != (PREP_B, n) or units.min() < 0 or units.max() >= PREP_K:
        fail(f"prep bench: units {tuple(units.shape)} in [{units.min().item()}, "
             f"{units.max().item()}]")
    units32 = kmeans_predict(feats32, cent)
    cos = torch.nn.functional.cosine_similarity(feats.reshape(-1, 768),
                                                feats32.reshape(-1, 768), dim=-1)
    rel = ((feats - feats32).abs().max() / feats32.abs().max()).item()
    agree = (units == units32).float().mean().item()
    if cos.min().item() < PREP_BF16_ROW_COS or rel > PREP_BF16_REL:
        fail(f"prep bench: bf16 features against float32 row-cos min {cos.min().item():.6f}, "
             f"max-abs/scale {rel:.3e} (bounds {PREP_BF16_ROW_COS}, {PREP_BF16_REL})")
    audio_s = PREP_B * PREP_SAMPLES / SAMPLE_RATE
    print(f"prep bench: B{PREP_B} x {PREP_SAMPLES / SAMPLE_RATE:.0f} s, mHuBERT-base to layer "
          f"{PREP_LAYER} in bf16 + K={PREP_K} argmin on float32 features ({n} frames a row): "
          f"wall {wall:.4f} s (median of {PREP_REPS}: {[round(w, 4) for w in walls]}), RTF "
          f"{audio_s / wall:.1f}, peak {peak_gb:.2f} GB; float32 forward {wall32:.4f} s (the "
          f"first at this shape); bf16 against float32: features row-cos min "
          f"{cos.min().item():.6f} mean {cos.mean().item():.6f}, max-abs/scale {rel:.3e}, "
          f"units equal {agree:.4f} ({len(torch.unique(units32))} distinct units under the "
          f"fitted codebook); {smi}")
    profile_run(torch, step, wall)
    print(f"phase prep bench: {time.perf_counter() - t0:.1f} s")


def run_prep_long(torch, model, mods, smi):
    """Phase 13: one 70 s utterance, float32, through the kernels and through
    the plain versions. Returns the flash_attention launches of the run
    through the kernels (one forward)."""
    from diffnorm_tpu_torch.models.kmeans import kmeans_predict
    from diffnorm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(23)
    wav = 0.1 * torch.randn(1, PREP_LONG_SAMPLES, generator=g, device="cuda")
    runs = {}
    with torch.no_grad():
        model(wav, output_layer=PREP_LAYER)  # warm-up at this shape
        for version in ("kernels", "plain"):
            with plain_versions(*mods) if version == "plain" else contextlib.nullcontext():
                torch.cuda.synchronize()
                _build.launch_counts.clear()
                t1 = time.perf_counter()
                feats = model(wav, output_layer=PREP_LAYER)[0]
                torch.cuda.synchronize()
                runs[version] = (feats, time.perf_counter() - t1,
                                 _build.launch_counts.get("flash_attention", 0))
    (feats, wall, n_flash), (ref, wall_ref, n_flash_ref) = runs["kernels"], runs["plain"]
    if n_flash != PREP_LAYER or n_flash_ref:
        fail(f"prep long form: flash_attention launched {n_flash} times through the kernels "
             f"and {n_flash_ref} through the plain versions, expected {PREP_LAYER} and 0")
    if feats.shape != (PREP_LONG_FRAMES, 768) or not torch.isfinite(feats).all():
        fail(f"prep long form: features {tuple(feats.shape)}, expected finite "
             f"[{PREP_LONG_FRAMES}, 768]")
    cos = torch.nn.functional.cosine_similarity(feats, ref, dim=-1)
    rel = ((feats - ref).abs().max() / ref.abs().max()).item()
    cent = fitted_codebook(torch, ref)
    units, units_ref = kmeans_predict(feats, cent), kmeans_predict(ref, cent)
    agree = (units == units_ref).float().mean().item()
    if cos.min().item() < PREP_ROW_COS or rel > PREP_REL or agree < PREP_UNIT_AGREE:
        fail(f"prep long form: kernels against plain versions row-cos min "
             f"{cos.min().item():.7f}, max-abs/scale {rel:.3e}, units equal {agree:.4f} "
             f"(bounds {PREP_ROW_COS}, {PREP_REL}, {PREP_UNIT_AGREE})")
    print(f"prep long form: 1 x {PREP_LONG_SAMPLES / SAMPLE_RATE:.0f} s ({PREP_LONG_FRAMES} "
          f"frames), float32, to layer {PREP_LAYER}: {wall:.4f} s through the kernels "
          f"(flash_attention launches {n_flash}), {wall_ref:.4f} s through the plain versions; "
          f"features row-cos min {cos.min().item():.7f}, max-abs/scale {rel:.3e}, units equal "
          f"{agree:.4f} under a fitted K={PREP_K} codebook ({len(torch.unique(units_ref))} "
          f"distinct); {smi}")
    print(f"phase prep long form: {time.perf_counter() - t0:.1f} s")
    return n_flash


def write_wav_pcm(path: Path, pcm) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def run_prep_cli(torch, model, smi):
    """Phase 14: cli.get_manifest, then cli.prepare dump-features,
    learn-kmeans (K=1000) and quantize on PREP_CLI_UTTS WAV utterances of 3-7
    s and a 70 s one, with the seeded float32 encoder written by
    weights.save_npz."""
    import numpy as np

    from diffnorm_tpu_torch.cli import get_manifest, prepare
    from diffnorm_tpu_torch.data.manifest import read_feature_manifest
    from diffnorm_tpu_torch.models.hubert import frames_for_samples
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.weights import save_npz, to_jax_params

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "audio").mkdir()
        rng = np.random.default_rng(24)
        lengths = {f"utt{i:02d}": int(rng.uniform(3.0, 7.0) * SAMPLE_RATE)
                   for i in range(PREP_CLI_UTTS)}
        lengths["long70s"] = PREP_LONG_SAMPLES
        for utt, n in lengths.items():
            write_wav_pcm(tmp / "audio" / f"{utt}.wav",
                          (rng.normal(size=n) * 3000).astype(np.int16))
        save_npz(str(tmp / "hubert.npz"), to_jax_params(model))
        feat, manifest = tmp / "feat", tmp / "train_audio.tsv"
        commands = [
            ("get_manifest", get_manifest, [str(tmp / "audio"), "--dest", str(manifest)]),
            ("dump-features", prepare, [
                "dump-features", "--manifest", str(manifest), "--hubert-ckpt",
                str(tmp / "hubert.npz"), "--layer", str(PREP_LAYER), "--out-dir", str(feat),
                "--split", "train"]),
            ("learn-kmeans", prepare, [
                "learn-kmeans", "--feat-dir", str(feat), "--split", "train",
                "--num-clusters", str(PREP_K), "--iters", "5", "--out", str(tmp / "km.npy")]),
            ("quantize", prepare, [
                "quantize", "--feat-dir", str(feat), "--split", "train", "--kmeans",
                str(tmp / "km.npy"), "--out", str(tmp / "train.units")]),
        ]
        walls = {}
        for what, cli, argv in commands:
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            t1 = time.perf_counter()
            if cli.main(argv) != 0:
                fail(f"prep entry point: {what} failed")
            torch.cuda.synchronize()
            walls[what] = time.perf_counter() - t1
            if what == "dump-features":
                n_flash = _build.launch_counts.get("flash_attention", 0)
        # the checks: the manifest, every feature's shape, the codebook, the units
        rows = manifest.read_text().splitlines()[1:]
        if sorted(rows) != sorted(f"{utt}.wav\t{n}" for utt, n in lengths.items()):
            fail(f"prep entry point: get_manifest wrote {rows[:3]}...")
        feats = read_feature_manifest(str(feat / "train.manifest.tsv"))
        frames = {utt: frames_for_samples(n) for utt, n in lengths.items()}
        if {utt: n for utt, (_, n) in feats.items()} != frames:
            fail("prep entry point: the feature manifest's lengths are not frames_for_samples")
        for utt, (path, n) in feats.items():
            x = np.load(path)
            if x.shape != (n, 768) or x.dtype != np.float32 or not np.isfinite(x).all():
                fail(f"prep entry point: {utt} features {x.shape} {x.dtype}")
        cent = np.load(tmp / "km.npy")
        if cent.shape != (PREP_K, 768) or not np.isfinite(cent).all():
            fail(f"prep entry point: centroids {cent.shape}")
        units = dict(line.split("|") for line in (tmp / "train.units").read_text().splitlines())
        for utt, n in frames.items():
            u = np.array(units.get(utt, "").split(), dtype=np.int64)
            if len(u) != n or u.min() < 0 or u.max() >= PREP_K:
                fail(f"prep entry point: {utt} has {len(u)} units, expected {n} in [0, {PREP_K})")
        if n_flash != PREP_LAYER:
            fail(f"prep entry point: dump-features launched flash_attention {n_flash} times, "
                 f"expected {PREP_LAYER} (the 70 s utterance)")
        audio_s = sum(lengths.values()) / SAMPLE_RATE
        print(f"phase entry point prep: get_manifest {walls['get_manifest']:.2f} s, "
              f"dump-features {walls['dump-features']:.2f} s ({len(lengths)} utterances, "
              f"{audio_s:.1f} s of audio, RTF {audio_s / walls['dump-features']:.1f} with the "
              f"encoder's load; flash_attention launches {n_flash}), learn-kmeans K={PREP_K} "
              f"{walls['learn-kmeans']:.2f} s ({sum(frames.values())} frames, 5 iterations), "
              f"quantize {walls['quantize']:.2f} s; every file checked; "
              f"{time.perf_counter() - t0:.1f} s in all; {smi}")


def write_eval_corpus(root: Path, seed: int = 15):
    """test.tsv over EVAL_SHORT .npy sources of EVAL_SHORT_FRAMES fbank frames
    and one of EVAL_LONG_FRAMES, with 40-250 unit targets, and a config.yaml
    with utterance CMVN."""
    import numpy as np

    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(seed)
    rows = []
    for i, n in enumerate([EVAL_SHORT_FRAMES] * EVAL_SHORT + [EVAL_LONG_FRAMES]):
        np.save(root / f"utt{i}.npy", rng.normal(size=(n, 80)).astype(np.float32))
        units = rng.integers(0, 1000, size=int(rng.integers(40, 251)))
        rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.npy", "src_n_frames": n,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
    write_translation_manifest(str(root / "test.tsv"), rows)
    (root / "config.yaml").write_text("input_feat_per_channel: 80\n"
                                      "transforms:\n  '*': [utterance_cmvn]\n")


def write_asr_checkpoint(torch, root: Path, seed: int = 16, config=None):
    """A seeded wav2vec2-CTC (or, by `config`'s model_type, HuBERT-CTC)
    checkpoint directory in Hugging Face's layout: config.json, vocab.json,
    tokenizer_config.json, preprocessor_config.json and pytorch_model.bin
    (torch.save), the positional conv's weight norm as weight_g / weight_v,
    as the released checkpoints store it. `config` defaults to ASR_CONFIG."""
    from diffnorm_tpu_torch.models.wav2vec2_ctc import POS_CONV, Wav2Vec2CTC, hf_key

    config = config or ASR_CONFIG
    root.mkdir()
    torch.manual_seed(seed)
    with torch.device("cuda"):
        model = Wav2Vec2CTC(config)
    sd = {hf_key(k, model.prefix): v.detach().cpu() for k, v in model.state_dict().items()}
    pos_conv = f"{model.prefix}.{POS_CONV}"
    v = sd.pop(pos_conv + ".weight")
    sd[pos_conv + ".weight_g"] = v.norm(dim=(0, 1), keepdim=True)
    sd[pos_conv + ".weight_v"] = v
    torch.save(sd, root / "pytorch_model.bin")
    del model, sd
    (root / "config.json").write_text(json.dumps(config))
    (root / "vocab.json").write_text(json.dumps({c: i for i, c in enumerate(ASR_VOCAB)}))
    (root / "tokenizer_config.json").write_text(json.dumps(dict(
        unk_token="<unk>", bos_token="<s>", eos_token="</s>", pad_token="<pad>",
        do_lower_case=False, word_delimiter_token="|")))
    (root / "preprocessor_config.json").write_text(json.dumps(dict(
        do_normalize=True, feature_size=1, padding_value=0.0, sampling_rate=SAMPLE_RATE,
        return_attention_mask=True)))


def in_process_hyps(torch, nar, root: Path, calibrate: bool = False):
    """H- unit strings of an in-process mask_predict_decode over the batches
    cli.generate makes (the same dataset, iterator and dtype): {id: units}.
    With `calibrate`, the int8 model's static scales are calibrated on the
    first batch's target canvas before its decode, as --quant-int8-static
    does."""
    from diffnorm_tpu_torch.cli.generate import strip_special
    from diffnorm_tpu_torch.data.dictionary import Dictionary
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.models.nar_transformer import calibrate_act_scales
    from diffnorm_tpu_torch.ops.quant import set_static_scales

    tgt_dict = Dictionary.unit_dictionary(1000)
    ds = SpeechToUnitDataset.from_tsv(str(root), "test", tgt_dict=tgt_dict)
    hyps = {}
    for batch in EpochBatchIterator(ds, EVAL_MAX_TOKENS, shuffle=False).next_epoch_itr():
        src = torch.from_numpy(batch["src_tokens"]).cuda()
        lengths = torch.from_numpy(batch["src_lengths"]).cuda()
        if calibrate:
            calibrate_act_scales(nar, src, lengths, torch.from_numpy(batch["target"]).cuda())
            set_static_scales(nar)
            calibrate = False
        tokens, _, _ = mask_predict_decode(nar, src, lengths, max_iter=EVAL_MAX_ITER,
                                           max_len=256)
        for row, sid in zip(tokens.cpu().numpy(), batch["id"].tolist()):
            hyps[sid] = strip_special(row, tgt_dict)
    return hyps


def read_hyps(path: Path):
    """{id: units} of a generate-{split}.txt's H- lines."""
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith("H-"):
            sid, _, units = line.split("\t")
            out[int(sid[2:])] = units
    return out


def run_eval(torch, smi):
    """Phase 15: scripts/s2ut_eval.sh through the port's four CLIs at full
    width: cli.generate (default, --init-unit-file, --cond-scale 2,
    --quant-int8 --quant-int8-static), eval.unit_bleu, cli.generate_waveform --dur-prediction and eval.asr_bleu
    with a seeded wav2vec2-large-lv60-shaped CTC checkpoint. Returns the
    flash_attention launches of the cli.generate runs and the text of the
    first run's hyp.unit."""
    import numpy as np

    from diffnorm_tpu_torch.cli import generate, generate_waveform
    from diffnorm_tpu_torch.cli.s2st import build_model
    from diffnorm_tpu_torch.data.audio import read_audio
    from diffnorm_tpu_torch.eval import asr_bleu, unit_bleu
    from diffnorm_tpu_torch.eval.bleu import scorer_name
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    t0 = time.perf_counter()
    nar, voc = s2st_models(torch)
    lines = LogLines()
    logging.getLogger("diffnorm_tpu_torch.generate").addHandler(lines)
    walls, flash = {}, {}

    def timed(what, fn):
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t1
        flash[what] = dict(_build.launch_counts)
        if rc != 0:
            fail(f"eval: {what} returned {rc}")
        return out.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_eval_corpus(tmp)
        save_npz(str(tmp / "nar.npz"), to_jax_variables(nar))
        save_npz(str(tmp / "voc.npz"), to_jax_variables(voc))
        (tmp / "voc.json").write_text(json.dumps(VOCODER_CFG))
        n_sent = EVAL_SHORT + 1
        gen = [str(tmp), "--task", "speech_to_speech_fasttranslate", "--target-code-size",
               "1000", "--arch", "nar_s2ut_conformer", "--path", str(tmp / "nar.npz"),
               "--gen-subset", "test", "--max-tokens", str(EVAL_MAX_TOKENS),
               "--iter-decode-max-iter", str(EVAL_MAX_ITER), *EVAL_WIDTH_FLAGS]
        res = tmp / "res"
        sent_s = {}
        for what, extra, out in (
                ("cli.generate", ["--cond-scale", "1.0"], res),
                ("cli.generate --init-unit-file", ["--init-unit-file", str(res / "hyp.unit")],
                 tmp / "res_init"),
                ("cli.generate --cond-scale 2", ["--cond-scale", "2"], tmp / "res_cg")):
            lines.lines.clear()
            timed(what, lambda: generate.main(gen + extra + ["--results-path", str(out)]))
            rate = [m for m in lines.lines if "sent/s" in m]
            summary = (out / "generate-test.txt").read_text().splitlines()[-1]
            hyps = read_hyps(out / "generate-test.txt")
            if sorted(hyps) != list(range(n_sent)) or not rate:
                fail(f"eval: {what} wrote ids {sorted(hyps)}, log {lines.lines}")
            sent_s[what] = rate[0]
            print(f"eval {what}: {rate[0]}; {summary}")
            if what == "cli.generate":
                printed = timed("eval.unit_bleu", lambda: unit_bleu.main(
                    [str(out / "generate-test.txt"), str(out)]))
                unit_lines = (out / "hyp.unit").read_text().splitlines()
                if len(unit_lines) != n_sent or not printed.startswith("unit BLEU: "):
                    fail(f"eval: unit_bleu wrote {len(unit_lines)} hyp.unit lines, "
                         f"printed {printed!r}")
                want = in_process_hyps(torch, nar, tmp)
                bf16_hyps = hyps
                if want != hyps:
                    bad = [i for i in want if want[i] != hyps.get(i)]
                    fail(f"eval: cli.generate's H- units differ from an in-process "
                         f"mask_predict_decode for ids {bad}")
                if flash[what].get("flash_attention", 0) < nar.decoder.n_layers:
                    fail(f"eval: cli.generate launched flash_attention "
                         f"{flash[what].get('flash_attention', 0)} times on the long-form "
                         f"source")
                forced = {int(line.split("\t")[0]): len(line.split("\t")[1].split()) + 1
                          for line in unit_lines}
            elif what == "cli.generate --init-unit-file":
                # canvas len(units) + 1: EOS at its end, or re-masked and filled
                bad = {i: (len(h.split()), forced[i]) for i, h in hyps.items()
                       if len(h.split()) not in (forced[i] - 1, forced[i])}
                if bad:
                    fail(f"eval: --init-unit-file canvases off their forced lengths "
                         f"(units, canvas) {bad}")
            elif any(len(h.split()) == 0 for h in hyps.values()):
                fail("eval: --cond-scale 2 gave an empty hypothesis")

        # the int8 decode with static scales calibrated on the first batch
        what, out = "cli.generate --quant-int8 --quant-int8-static", tmp / "res_int8"
        int8_flags = ["--quant-int8", "--quant-int8-static"]
        lines.lines.clear()
        timed(what, lambda: generate.main(gen + int8_flags + ["--results-path", str(out)]))
        rate = [m for m in lines.lines if "sent/s" in m]
        calibrated = [m for m in lines.lines if "calibrated static int8" in m]
        hyps = read_hyps(out / "generate-test.txt")
        if sorted(hyps) != list(range(n_sent)) or not rate or len(calibrated) != 1:
            fail(f"eval: {what} wrote ids {sorted(hyps)}, log {lines.lines}")
        sent_s[what] = rate[0]
        qnar = build_model(generate.parse_args(gen + int8_flags), str(tmp / "nar.npz"),
                           torch.device("cuda"), torch.bfloat16, quant_int8=True)
        want = in_process_hyps(torch, qnar, tmp, calibrate=True)
        if want != hyps:
            bad = [i for i in want if want[i] != hyps.get(i)]
            fail(f"eval: {what}'s H- units differ from an in-process int8-static decode "
                 f"for ids {bad}")
        if flash[what].get("flash_attention", 0) < nar.decoder.n_layers:
            fail(f"eval: {what} launched flash_attention "
                 f"{flash[what].get('flash_attention', 0)} times on the long-form source")
        pairs = [(hyps[i].split(), bf16_hyps[i].split()) for i in hyps]
        int8_agree = sum(a == b for h, r in pairs for a, b in zip(h, r))
        int8_total = sum(max(len(h), len(r)) for h, r in pairs)
        print(f"eval {what}: {calibrated[0]}; {rate[0]}; H- units equal an in-process "
              f"int8-static decode; {int8_agree / max(int8_total, 1):.4f} of units equal to "
              f"the bf16 run's; {(out / 'generate-test.txt').read_text().splitlines()[-1]}")
        logging.getLogger("diffnorm_tpu_torch.generate").removeHandler(lines)
        del nar, qnar

        wav_dir = res / "wav"
        timed("cli.generate_waveform", lambda: generate_waveform.main([
            "--in-code-file", str(res / "hyp.unit"), "--vocoder", str(tmp / "voc.npz"),
            "--vocoder-cfg", str(tmp / "voc.json"), "--results-path", str(wav_dir),
            "--dur-prediction"]))
        wavs = [read_audio(str(wav_dir / f"{i}_pred.wav"))[0] for i in range(n_sent)]
        if sorted(p.name for p in wav_dir.iterdir()) != sorted(
                f"{i}_pred.wav" for i in range(n_sent)):
            fail(f"eval: generate_waveform wrote {sorted(p.name for p in wav_dir.iterdir())}")
        if min(len(w) for w in wavs) < 640 or not all(np.isfinite(w).all() for w in wavs):
            fail("eval: generate_waveform wrote a short or non-finite wav")
        audio_s = sum(len(w) for w in wavs) / SAMPLE_RATE
        hyp_units = (res / "hyp.unit").read_text()

        asr_dir = tmp / "asr"
        write_asr_checkpoint(torch, asr_dir)
        (tmp / "refs.txt").write_text("".join("the cat sat on the mat\n" for _ in wavs))
        printed = timed("eval.asr_bleu", lambda: asr_bleu.main([
            "--audio-dir", str(wav_dir), "--reference-path", str(tmp / "refs.txt"),
            "--lang", "en", "--asr-model", str(asr_dir),
            "--transcripts-path", str(tmp / "asr.txt")]))
        if not printed.startswith("ASR-BLEU: "):
            fail(f"eval: asr_bleu printed {printed!r}")
        n_transcripts = len((tmp / "asr.txt").read_text().splitlines())

        # the ASR on the card against the port's CPU float32 forward
        card = asr_bleu.ASRGenerator(model_name=str(asr_dir), device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for w in wavs:
            card.transcribe(w)
        asr_rate = audio_s / (time.perf_counter() - t1)
        longest = max(wavs, key=len)
        t1 = time.perf_counter()
        card.transcribe(longest)
        torch.cuda.synchronize()
        one = time.perf_counter() - t1
        print(f"eval ASR: one transcription of the longest wav ({len(longest) / SAMPLE_RATE:.2f} "
              f"s) {one:.4f} s; {smi}")
        profile_run(torch, lambda: card.transcribe(longest), one)
        cpu = asr_bleu.ASRGenerator(model_name=str(asr_dir), device="cpu")
        cos_min, agree_min = 1.0, 1.0
        for w in sorted(wavs, key=len)[:ASR_CHECK_WAVS]:
            got = card.logits(w).float().cpu()
            ref = cpu.logits(w)
            cos_min = min(cos_min, torch.nn.functional.cosine_similarity(
                got, ref, dim=-1).min().item())
            agree_min = min(agree_min, (got.argmax(-1) == ref.argmax(-1)).float().mean().item())
        check = (f"ASR logits on the card against the CPU float32 forward on the "
                 f"{ASR_CHECK_WAVS} shortest wavs: row-cos min {cos_min:.6f}, argmax agreement "
                 f"min {agree_min:.4f}")
        if cos_min < ASR_ROW_COS or agree_min < ASR_ARGMAX_AGREE:
            fail(f"eval: {check}")
        del card, cpu

    gen_flash = {w: flash[w].get("flash_attention", 0) for w in sent_s}
    print("eval walls (s): " + ", ".join(f"{w} {t:.2f}" for w, t in walls.items())
          + f"; flash_attention launches {gen_flash}, in asr_bleu "
          f"{flash['eval.asr_bleu']}; {smi}")
    print(f"eval: {n_sent} sentences ({EVAL_SHORT} x {EVAL_SHORT_FRAMES} frames and 1 x "
          f"{EVAL_LONG_FRAMES}), --max-tokens {EVAL_MAX_TOKENS}; cli.generate "
          f"{n_sent / walls['cli.generate']:.2f} sent/s over its wall with the model's load "
          f"({sent_s['cli.generate']}); generate_waveform {n_sent} wavs, {audio_s:.1f} s of "
          f"audio; asr_bleu {printed.strip()} ({scorer_name()} scorer) over {n_transcripts} "
          f"transcripts, {audio_s / walls['eval.asr_bleu']:.1f} audio-s per wall-s with the "
          f"checkpoint's load, {asr_rate:.1f} without it (the recognizer alone, one wav at "
          f"a time); {check}; {smi}")
    print(f"phase eval: {time.perf_counter() - t0:.1f} s")
    return sum(gen_flash.values()), hyp_units


def gan_batch(rows: int, seed: int = 70):
    """A collated batch of the fine-tune at scripts/full_recipe.sh's crop:
    `rows` x GAN_CROP units (runs of 1-3 equal units, as real units come)
    with their 320-samples-a-unit waveforms and run-length labels."""
    import numpy as np

    from diffnorm_tpu_torch.data.code_dataset import SAMPLES_PER_UNIT, run_lengths

    rng = np.random.default_rng(seed)
    code = np.stack([np.repeat(rng.integers(0, 1000, size=GAN_CROP),
                               rng.integers(1, 4, size=GAN_CROP))[:GAN_CROP]
                     for _ in range(rows)]).astype(np.int32)
    labels = [run_lengths(row, GAN_CROP) for row in code]
    return {"code": code,
            "wav": (rng.normal(size=(rows, GAN_CROP * SAMPLES_PER_UNIT)) * 0.1
                    ).astype(np.float32),
            "dur_code": np.stack([d for d, _ in labels]),
            "durations": np.stack([n for _, n in labels])}


def gan_trainer(torch, device, variables=None, bf16_disc=False):
    """GanTrainer of the released code-HiFi-GAN (its duration predictor on)
    with full-width MPD (2, 3, 5, 7, 11) and MSD (3 scales), JAX's
    defaults, the weights of `variables` where given; and its variables."""
    from diffnorm_tpu_torch.cli.train_vocoder import build_generator
    from diffnorm_tpu_torch.train.gan_trainer import GanTrainer

    torch.manual_seed(17)
    with torch.device(device):
        gen = build_generator(VOCODER_CFG)
    trainer = GanTrainer(gen, {"bf16_disc": bf16_disc}, torch.device(device))
    if variables is not None:
        trainer.load_variables(variables)
    return trainer, trainer.variables()


def run_train_vocoder(torch, smi):
    """Phase 17: GAN updates of recipe stage 6 at full width, B32 x 28 units
    (8,960 samples a row): float32 with TF32 on for the cuDNN convs (torch's
    default, what cli.train_vocoder runs), float32 with TF32 off, and
    --bf16-disc; each from one init, GAN_WARMUP updates then the median of
    GAN_TIMED, peak memory and a profile. Then one update on the card (TF32
    off) against the port's CPU float32 update from the same weights on the
    batch's first GAN_CHECK_B rows."""
    t0 = time.perf_counter()
    batch = gan_batch(GAN_B)
    _, init = gan_trainer(torch, "cpu")
    for what, tf32, bf16_disc in (("float32, TF32 on", True, False),
                                  ("float32, TF32 off", False, False),
                                  ("--bf16-disc, TF32 on", True, True)):
        torch.backends.cudnn.allow_tf32 = tf32
        trainer, _ = gan_trainer(torch, "cuda", init, bf16_disc)
        for _ in range(GAN_WARMUP):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(GAN_TIMED):
            t1 = time.perf_counter()
            mets = trainer.train_step(batch)  # ends in the metrics' copy to the host
            walls.append(time.perf_counter() - t1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(v) for v in mets.values()):
            fail(f"vocoder train {what}: metrics {mets}")
        wall = statistics.median(walls)
        print(f"vocoder train {what}: B{GAN_B} x {GAN_CROP} units ({GAN_CROP * 320} samples a "
              f"row): {1e3 * wall:.1f} ms an update (median of {GAN_TIMED} after {GAN_WARMUP} "
              f"warm-up; {1e3 * min(walls):.1f}-{1e3 * max(walls):.1f}), peak {peak_gb:.2f} GB, "
              f"last metrics " + " ".join(f"{k} {v:.4f}" for k, v in mets.items()) + f"; {smi}")
        profile_run(torch, lambda: trainer.train_step(batch), wall)
        del trainer
    torch.backends.cudnn.allow_tf32 = False
    small = {k: v[:GAN_CHECK_B] for k, v in batch.items()}
    card, _ = gan_trainer(torch, "cuda", init)
    got = card.train_step(small)
    cpu, _ = gan_trainer(torch, "cpu", init)
    want = cpu.train_step(small)
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    line = (f"vocoder train: one update on the card (float32, TF32 off) against the CPU "
            f"float32 update, B{GAN_CHECK_B}: relative differences "
            + " ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f" (bounds loss_d {GAN_LOSS_D_REL}, the rest {GAN_G_REL})")
    if rel["loss_d"] > GAN_LOSS_D_REL or max(rel.values()) > GAN_G_REL:
        fail(line)
    print(line)
    print(f"phase vocoder train: {time.perf_counter() - t0:.1f} s")


def write_vocoder_corpus(root: Path, seed: int = 71, n_utts: int = GAN_CLI_UTTS):
    """`n_utts` seeded 16 kHz WAVs of 3-7 s and a train.units file of 50 Hz
    units (runs of 1-3), the config JSON."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_utts):
        n = int(rng.uniform(3.0, 7.0) * SAMPLE_RATE)
        write_wav_pcm(root / f"v{i}.wav", (rng.normal(size=n) * 3000).astype(np.int16))
        units = np.repeat(rng.integers(0, 1000, size=n // 320), rng.integers(1, 4, size=n // 320))
        lines.append(f"v{i}|" + " ".join(map(str, units[:n // 320])))
    (root / "train.units").write_text("\n".join(lines) + "\n")
    (root / "voc.json").write_text(json.dumps(VOCODER_CFG))


def run_train_vocoder_cli(torch, hyp_units: str, smi):
    """Phase 17's entry point: cli.train_vocoder on 24 WAVs at the recipe's
    --batch-size 32 --crop-units 28, 10 updates with a save at 10, resumed to
    20, then cli.generate_waveform --dur-prediction from the last step
    directory on phase 15's hyp.unit; each wall."""
    import numpy as np

    from diffnorm_tpu_torch.cli import generate_waveform, train_vocoder
    from diffnorm_tpu_torch.data.audio import read_audio

    t0 = time.perf_counter()
    lines = LogLines()
    logging.getLogger("diffnorm_tpu_torch.train_vocoder").addHandler(lines)
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_vocoder_corpus(tmp)
        base = ["--units-file", str(tmp / "train.units"), "--audio-dir", str(tmp),
                "--vocoder-cfg", str(tmp / "voc.json"), "--save-dir", str(tmp / "ckpt"),
                "--batch-size", "32", "--crop-units", str(GAN_CROP),
                "--save-interval-updates", "10", "--log-interval", "5"]
        for what, max_update, want in (
                ("cli.train_vocoder", 10, ["saved checkpoint at step 10",
                                           "vocoder training done at step 10"]),
                ("cli.train_vocoder resumed", 20, ["resumed from step 10",
                                                   "saved checkpoint at step 20",
                                                   "vocoder training done at step 20"])):
            lines.lines.clear()
            t1 = time.perf_counter()
            if train_vocoder.main(base + ["--max-update", str(max_update)]) != 0:
                fail(f"{what} failed")
            torch.cuda.synchronize()
            walls[what] = time.perf_counter() - t1
            missing = [m for m in want if m not in lines.lines]
            if missing or "resumed" in " ".join(lines.lines) and max_update == 10:
                fail(f"{what}: log lacks {missing}: {lines.lines}")
            steps = [m for m in lines.lines if m.startswith("step ")]
            print(f"vocoder {what}: {walls[what]:.2f} s; {steps[-1] if steps else ''}")
        step_dir = tmp / "ckpt" / "step_000000020"
        (tmp / "hyp.unit").write_text(hyp_units)
        t1 = time.perf_counter()
        if generate_waveform.main(["--in-code-file", str(tmp / "hyp.unit"), "--vocoder",
                                   str(step_dir), "--vocoder-cfg", str(tmp / "voc.json"),
                                   "--results-path", str(tmp / "wav"),
                                   "--dur-prediction"]) != 0:
            fail("cli.generate_waveform on the fine-tuned step directory failed")
        walls["cli.generate_waveform"] = time.perf_counter() - t1
        n_lines = len([line for line in hyp_units.splitlines() if line.strip()])
        wavs = [read_audio(str(tmp / "wav" / f"{i}_pred.wav"))[0] for i in range(n_lines)]
        if not wavs or not all(len(w) > 0 and np.isfinite(w).all() for w in wavs):
            fail("cli.generate_waveform wrote an empty or non-finite wav")
    logging.getLogger("diffnorm_tpu_torch.train_vocoder").removeHandler(lines)
    print(f"phase entry point vocoder train: walls (s) "
          + ", ".join(f"{w} {t:.2f}" for w, t in walls.items())
          + f"; {len(wavs)} wavs from the step-20 directory, "
          f"{sum(len(w) for w in wavs) / SAMPLE_RATE:.1f} s of audio; {smi}")
    print(f"phase entry point vocoder train: {time.perf_counter() - t0:.1f} s")


def write_synthesis_corpus(root: Path, n: int, frames: int, feature_dim: int,
                           seed: int = 18) -> Path:
    """test.tsv over `n` utterances of `frames` units, no unit equal to the
    one before it (so each reduces to itself and batches at `frames`), and
    their feature dumps under feat/; returns the feature directory."""
    import numpy as np

    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(seed)
    feat_dir = root / "feat"
    feat_dir.mkdir(parents=True)
    rows, lines = [], [str(feat_dir)]
    for i in range(n):
        units = np.cumsum(rng.integers(1, 1000, size=frames)) % 1000
        np.save(feat_dir / f"utt{i}.feat.npy",
                rng.normal(size=(frames, feature_dim)).astype(np.float32))
        lines.append(f"utt{i}.feat.npy\t{frames}")
        rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.wav", "src_n_frames": frames,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": frames})
    (feat_dir / "test.manifest.tsv").write_text("\n".join(lines) + "\n")
    write_translation_manifest(str(root / "test.tsv"), rows)
    return feat_dir


def normalizer_flags(widths: dict) -> list:
    """cli.train's and cli.diff_norm_synthesis's width flags for
    LatentDiffusionModule's `widths` (none for the released shape)."""
    flags = []
    for key, value in widths.items():
        name = "hidden-dim" if key == "dim" else key.replace("_", "-")
        flags += [f"--{name}", json.dumps(value) if isinstance(value, list) else str(value)]
    return flags


def nar_state_for(torch, args, seed: int):
    """fairseq_nar_state at the widths of cli.train-style `args`."""
    return fairseq_nar_state(
        torch, seed, vocab_size=args.target_code_size + 4, dim=args.encoder_embed_dim,
        ffn_dim=args.encoder_ffn_embed_dim, encoder_layers=args.encoder_layers,
        encoder_heads=args.encoder_attention_heads, decoder_layers=args.decoder_layers,
        decoder_heads=args.decoder_attention_heads,
        depthwise_kernel_size=args.depthwise_conv_kernel_size,
        conv_channels=args.conv_channels, conv_kernel_sizes=args.conv_kernel_sizes)


@contextlib.contextmanager
def first_update(trainer_cls):
    """Record the batches and the metrics of each trainer's first
    train_step: yields the list of (batches, metrics)."""
    seen, step = [], trainer_cls.train_step

    def train_step(self, batches):
        mets = step(self, batches)
        if not getattr(self, "_first_seen", False):
            self._first_seen = True
            seen.append((batches, mets))
        return mets

    trainer_cls.train_step = train_step
    try:
        yield seen
    finally:
        trainer_cls.train_step = step


def run_checkpoints_in(torch, mods, smi):
    """Phase 18: seeded fairseq checkpoints at the released widths (the
    diff_discrete normalizer of phase 3, the nar_s2ut_conformer of phase 5,
    full-width MPD and MSD) in the released envelope, through
    cli.convert_checkpoint; cli.diff_norm_synthesis --ckpt against an
    in-process ddim_sample of the same .pt and the plain versions;
    cli.generate --path against an in-process decode; cli.validate against
    an in-process criterion forward; cli.average_checkpoints; cli.train
    --restore-file --reset-optimizer against an in-process first update.
    Returns the launches of the synthesis and generate runs."""
    import copy

    import numpy as np

    from diffnorm_tpu_torch.cli import average_checkpoints, convert_checkpoint, diff_norm_synthesis
    from diffnorm_tpu_torch.cli import generate, validate
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.data.iterators import iterate_valid
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.ops.unit_reduce import reduce_units
    from diffnorm_tpu_torch.tasks import TASKS
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.train.trainer import BATCH_KEYS, Trainer, TrainerConfig, summarize
    from diffnorm_tpu_torch.utils import convert_weights as cw
    from diffnorm_tpu_torch.weights import (
        flatten_tree,
        from_jax_variables,
        save_npz,
        unflatten_tree,
    )

    t0 = time.perf_counter()
    walls, launches = {}, {}
    conv_log = LogLines()
    logging.getLogger("diffnorm_tpu_torch.convert_checkpoint").addHandler(conv_log)

    def timed(what, fn):
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t1
        launches[what] = dict(_build.launch_counts)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        eval_root = tmp / "eval"
        eval_root.mkdir()
        write_eval_corpus(eval_root)
        nar_flags = ["--task", "speech_to_speech_fasttranslate", "--target-code-size", "1000",
                     "--arch", "nar_s2ut_conformer", "--path", str(tmp / "nar"),
                     *CLI_NAR_DEPTH]
        vargs = validate.parse_args([str(eval_root), *nar_flags, "--valid-subset", "test",
                                     "--max-tokens", str(EVAL_MAX_TOKENS)])
        # 1.-2. the released envelopes as .pt files, then cli.convert_checkpoint
        states = {"diffusion": fairseq_diffusion_state(torch, CKPT_SEED, **CKPT_DIFFUSION),
                  "nar": nar_state_for(torch, vargs, CKPT_SEED + 1)}
        envelopes = {
            "diffusion": fairseq_envelope(torch, states["diffusion"], "ddpm_discrete_loss"),
            "nar": fairseq_envelope(torch, states["nar"]),
            "gan_discriminators": discriminator_envelope(
                torch, *fairseq_discriminator_states(torch, CKPT_SEED + 2, CKPT_DISC_WIDTH))}
        sizes = {}
        for family, env in envelopes.items():
            path = tmp / f"{family}.pt"
            torch.save(env, path)
            sizes[family] = path.stat().st_size
            conv_log.lines.clear()
            rc = timed(f"convert {family}", lambda: convert_checkpoint.main([
                "--type", family, "--input", str(path), "--output", str(tmp / family)]))
            balanced = [m for m in conv_log.lines if "key inventory balanced" in m]
            if rc != 0 or not balanced:
                fail(f"checkpoints in: cli.convert_checkpoint --type {family}: rc {rc}, log "
                     f"{conv_log.lines}")
            print(f"checkpoints in: {family}.pt {sizes[family] / 1e6:.1f} MB (the released "
                  f"envelope), cli.convert_checkpoint {walls[f'convert {family}']:.2f} s: "
                  f"{balanced[0]}")
        del envelopes
        logging.getLogger("diffnorm_tpu_torch.convert_checkpoint").removeHandler(conv_log)

        # 3. DDIM normalization from the converted normalizer
        with torch.device("cuda"):
            model = LatentDiffusionModule(**CKPT_DIFFUSION)
        feature_dim, latent_dim = model.vae.decoder_tf.dim, model.denoiser.final_proj.out_features
        root = tmp / "synth"
        feat_dir = write_synthesis_corpus(root, B, T, feature_dim)
        out = tmp / "normalized"
        rc = timed("cli.diff_norm_synthesis --ckpt", lambda: diff_norm_synthesis.main([
            str(root), "--ckpt", str(tmp / "diffusion"), "--tgt-feat-dir", str(feat_dir),
            "--output-dir", str(out), "--splits", "test", "--start-step", str(START_STEP),
            "--batch-size", str(B), "--seed", "1", *normalizer_flags(CKPT_DIFFUSION)]))
        got = ([line.split("\t") for line in (out / "test.tsv").read_text().splitlines()[1:]]
               if rc == 0 else [])
        syn_launches = launches["cli.diff_norm_synthesis --ckpt"]
        steps = START_STEP - 1
        # two FiLM norms a transformer layer, one chain launch a WaveNet layer
        # (through every stack), each DDIM step
        norms = 2 * model.denoiser.transformer.depth * steps
        chains = model.denoiser.wavenet.layers * steps
        if len(got) != B or syn_launches.get("rms_norm_film", 0) < norms \
                or syn_launches.get("wavenet_chain", 0) < chains:
            fail(f"checkpoints in: cli.diff_norm_synthesis --ckpt: rc {rc}, {len(got)} rows, "
                 f"launches {syn_launches}")
        from_jax_variables(model, {"params": cw.convert_diffusion_state(states["diffusion"])})
        model = model.to(torch.bfloat16).eval()
        feature = torch.from_numpy(np.stack([np.load(feat_dir / f"utt{i}.feat.npy")
                                             for i in range(B)])).cuda()
        mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
        enc, init = diff_norm_synthesis.draw_noise(
            torch.Generator(device="cuda").manual_seed(1), (B, T, latent_dim),
            torch.device("cuda"))
        units, recon = ddim_sample(model, feature, mask, start_step=START_STEP, stride=1,
                                   enc_noise=enc, init_noise=init, device="cuda")
        want = [" ".join(str(int(u)) for u in reduce_units(row)[0])
                for row in units.cpu().numpy()]
        bad = [i for i, (row, w) in enumerate(zip(got, want))
               if row[0] != f"utt{i}" or row[3] != w]
        if bad:
            fail(f"checkpoints in: cli.diff_norm_synthesis --ckpt's manifest differs from an "
                 f"in-process ddim_sample of the same .pt on rows {bad[:10]}")
        with plain_versions(*mods):
            _, recon_ref = ddim_sample(model, feature, mask, start_step=START_STEP, stride=1,
                                       enc_noise=enc, init_noise=init, device="cuda")
        cos = torch.nn.functional.cosine_similarity(
            recon.float().reshape(-1, feature_dim), recon_ref.float().reshape(-1, feature_dim),
            dim=-1)
        if not torch.isfinite(recon).all() or cos.min().item() <= PATH_ROW_COS:
            fail(f"checkpoints in: converted normalizer's recon row-cos {cos.min().item():.5f} "
                 f"against the plain versions")
        print(f"checkpoints in: cli.diff_norm_synthesis --ckpt <converted normalizer> "
              f"B{B}xT{T}, {steps} DDIM steps, bf16: "
              f"{walls['cli.diff_norm_synthesis --ckpt']:.2f} s with the load, manifest equal "
              f"line for line to an in-process ddim_sample of the .pt, launches {syn_launches}; "
              f"recon row-cos against the plain versions min {cos.min().item():.5f}; {smi}")
        del model, feature, recon, recon_ref, units

        # 4. decode and validation from the converted NAR (phase 15's corpus)
        res = tmp / "res"
        rc = timed("cli.generate --path", lambda: generate.main([
            str(eval_root), *nar_flags, "--gen-subset", "test", "--max-tokens",
            str(EVAL_MAX_TOKENS), "--iter-decode-max-iter", str(EVAL_MAX_ITER),
            "--results-path", str(res)]))
        task = TASKS[vargs.task](vargs)
        with torch.device("cuda"):
            nar = task.build_model()
        from_jax_variables(nar, cw.convert_nar_state(states["nar"]))
        want = in_process_hyps(torch, copy.deepcopy(nar).to(torch.bfloat16).eval(), eval_root)
        hyps = read_hyps(res / "generate-test.txt") if rc == 0 else {}
        gen_flash = launches["cli.generate --path"].get("flash_attention", 0)
        if want != hyps or gen_flash < nar.decoder.n_layers:
            bad = [i for i in want if want[i] != hyps.get(i)]
            fail(f"checkpoints in: cli.generate --path's H- units differ from an in-process "
                 f"decode for ids {bad} (rc {rc}), flash_attention launches {gen_flash}")
        vals = timed("cli.validate --path", lambda: validate.validate(vargs))
        criterion, rng, rows = task.build_criterion(), np.random.default_rng(vargs.seed), []
        dataset = task.dataset("test")
        dataset[0]  # the CLI's example draw
        with torch.no_grad():
            for batch in iterate_valid(dataset, EVAL_MAX_TOKENS):
                batch = task.prepare_batch(batch, rng)
                _, mets = criterion(nar.eval(), {k: torch.as_tensor(batch[k]).cuda()
                                                 for k in BATCH_KEYS if batch.get(k) is not None})
                rows.append({k: float(v) for k, v in mets.items()})
        ref = summarize(rows)
        rel = max(abs(vals[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
        if set(vals) != set(ref) or rel > VALID_REL:
            fail(f"checkpoints in: cli.validate {vals} against the in-process criterion {ref}")
        print(f"checkpoints in: cli.generate --path <converted NAR> "
              f"{walls['cli.generate --path']:.2f} s, H- units equal an in-process decode of "
              f"the .pt, flash_attention {gen_flash} launches; cli.validate --path "
              f"{walls['cli.validate --path']:.2f} s: loss {vals['loss']:.6f} nll_loss "
              f"{vals['nll_loss']:.6f} (float32), the in-process criterion within {rel:.1e} "
              f"relative; {smi}")
        del nar

        # 5. averaging, then a warm start from the average
        second = cw.convert_nar_state(nar_state_for(torch, vargs, CKPT_SEED + 3))
        save_npz(str(tmp / "nar2.npz"), second)
        avg = tmp / "avg"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = timed("cli.average_checkpoints", lambda: average_checkpoints.main([
                "--inputs", str(tmp / "nar"), str(tmp / "nar2.npz"), "--output", str(avg)]))
        second = flatten_tree(second)
        mean = {k: ((v.astype(np.float64) + second[k]) / 2).astype(np.float32)
                for k, v in flatten_tree(load_variables(str(tmp / "nar"))).items()}
        got = flatten_tree(load_variables(str(avg))) if rc == 0 else {}
        worst = max((float(np.abs(got[k] - m).max() / max(np.abs(m).max(), 1e-12))
                     for k, m in mean.items() if k in got), default=1.0)
        if set(got) != set(mean) or worst > 1e-6:
            fail(f"checkpoints in: cli.average_checkpoints rc {rc}, worst leaf {worst:.2e}")
        corpus = tmp / "nar_corpus"
        corpus.mkdir()
        write_nar_corpus(corpus)
        argv = [str(corpus), "--config-yaml", "config.yaml", "--task",
                "speech_to_speech_fasttranslate", "--target-code-size", "1000", "--criterion",
                "nar_speech_to_unit", "--label-smoothing", "0.2", "--arch", "nar_s2ut_conformer",
                "--dropout", "0.1", "--save-dir", str(tmp / "warm"), "--lr", "5e-4",
                "--warmup-updates", "10000", "--clip-norm", "10.0", "--max-update", "2",
                "--max-tokens", "8000", "--seed", "42", "--dtype", "bfloat16",
                "--log-interval", "1", "--restore-file", str(avg), "--reset-optimizer",
                *CLI_NAR_DEPTH]
        train_log = LogLines()
        logging.getLogger("diffnorm_tpu_torch.train").addHandler(train_log)
        with first_update(Trainer) as seen:
            rc = timed("cli.train --restore-file --reset-optimizer",
                       lambda: train_cli.main(argv))
        logging.getLogger("diffnorm_tpu_torch.train").removeHandler(train_log)
        if rc != 0 or not seen or not any(f"warm-started params from {avg}" in m
                                          for m in train_log.lines):
            fail(f"checkpoints in: cli.train --restore-file: rc {rc}, log {train_log.lines}")
        args = train_cli.parse_args(argv)
        task = TASKS[args.task](args)
        with torch.device("cuda"):
            nar = task.build_model()
        from_jax_variables(nar, unflatten_tree(mean))
        trainer = Trainer(TrainerConfig(
            lr=args.lr, warmup_updates=args.warmup_updates, warmup_init_lr=args.warmup_init_lr,
            adam_betas=args.adam_betas, clip_norm=args.clip_norm, dtype=args.dtype,
            seed=args.seed), nar, task.build_criterion())
        batches, cli_mets = seen[0]
        mets = trainer.train_step(batches)
        rel = abs(mets["loss"] - cli_mets["loss"]) / abs(mets["loss"])
        if rel > WARM_LOSS_REL:
            fail(f"checkpoints in: cli.train --restore-file's first loss {cli_mets['loss']} "
                 f"against {mets['loss']} in process")
        print(f"checkpoints in: cli.average_checkpoints {walls['cli.average_checkpoints']:.2f} s "
              f"(worst leaf {worst:.1e} of the mean); cli.train --restore-file <average> "
              f"--reset-optimizer, 2 updates: "
              f"{walls['cli.train --restore-file --reset-optimizer']:.2f} s, first loss "
              f"{cli_mets['loss']:.6f} against {mets['loss']:.6f} in process ({rel:.1e}); {smi}")
        del nar, trainer
    print("checkpoints in: walls (s) " + ", ".join(f"{w} {t:.2f}" for w, t in walls.items())
          + "; .pt sizes (MB) " + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in sizes.items())
          + f"; {smi}")
    print(f"phase checkpoints in: {time.perf_counter() - t0:.1f} s")
    return {"rms_norm_film": syn_launches.get("rms_norm_film", 0),
            "wavenet_chain": syn_launches.get("wavenet_chain", 0),
            "flash_attention": gen_flash}


def write_options_data(root: Path, rng, units_by_split=None):
    """The aux tasks' files under `root`: the letter dictionary, the
    multitask YAML in the fairseq docs' form (paths relative to it) and, for
    each split in `units_by_split` ({split: {id: unit count}}), each task's
    {split}.tsv of seeded letter texts: letters (with "|" between words)
    numbering a quarter of the utterance's units for the decoder CTC task,
    whose canvas holds half as many steps, and half of them for the others.
    Returns the YAML's path."""
    import yaml

    letters = root / "letters"
    letters.mkdir(exist_ok=True)
    (letters / "dict.txt").write_text("".join(f"{c} 1\n" for c in OPT_LETTERS))
    config = {}
    for name, decoder_type, tap, layer, weight in OPT_TASKS:
        (root / name).mkdir(exist_ok=True)
        config[name] = {"decoder_type": decoder_type, "dict": "letters/dict.txt", "data": name,
                        tap: layer, "loss_weight": weight}
        if decoder_type == "transformer":
            config[name]["decoder_args"] = {"dropout": 0.0}
        for split, units in (units_by_split or {}).items():
            share = 4 if decoder_type == "ctc" else 2
            lines = [f"{uid}\t{' '.join(rng.choice(OPT_LETTERS, size=max(n // share, 1)))}"
                     for uid, n in units.items()]
            (root / name / f"{split}.tsv").write_text("id\ttgt_text\n" + "\n".join(lines) + "\n")
    path = root / "multitask.yaml"
    path.write_text(yaml.safe_dump(config))
    return path


def options_batch(rng, tasks, src_lengths, tgt_units):
    """A prepared training batch of the model with every option: phase 10's
    NAR batch stacked to OPT_K (packed canvas, sub-frame target), seeded
    letter targets for each aux task (lengths as write_options_data's),
    256-d speaker embeddings and a ctc_target over the encoder frames."""
    import numpy as np

    from diffnorm_tpu_torch.data.batching import bucket_length
    from diffnorm_tpu_torch.data.multitask import collate_text_targets
    from diffnorm_tpu_torch.models.stacked import stack_target
    from diffnorm_tpu_torch.tasks.nar_s2ut_task import random_mask

    batch = nar_batch(rng, src_lengths, tgt_units)
    packed, sub = stack_target(batch["target"], 1000, OPT_K)
    batch.update(target=sub, target_packed=packed, prev_target=random_mask(packed, rng))
    vocab = len(OPT_LETTERS) + 4
    batch["multitask"] = {}
    for name, tc in tasks.items():
        share, eos = (4, []) if tc.decoder_type == "ctc" else (2, [2])
        targets = [np.append(rng.integers(4, vocab, size=max(n // share, 1)), eos).astype(
            np.int32) for n in tgt_units]
        entry = collate_text_targets(targets, with_prev=tc.decoder_type != "ctc",
                                     pad_to=bucket_length(max(len(t) for t in targets)))
        entry["loss_weight"] = np.float32(tc.get_loss_weight(0))
        batch["multitask"][name] = entry
    b = len(src_lengths)
    batch["tgt_speaker"] = rng.normal(size=(b, OPT_SPK_DIM)).astype(np.float32)
    n_ctc = [max(int(n) // 16, 1) for n in src_lengths]  # a quarter of the subsampled frames
    ctc = np.full((b, max(n_ctc)), 1, np.int32)
    for i, n in enumerate(n_ctc):
        ctc[i, :n] = rng.integers(4, vocab, size=n)
    batch["ctc_target"] = ctc
    return batch


def options_model(torch, tasks, **kw):
    """The released nar_s2ut_conformer with every option, seeded, on the
    card in float32: stacked units, the aux heads of `tasks`, the CTC head,
    the speaker projection."""
    import types

    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
    from diffnorm_tpu_torch.tasks.multitask_mixin import MultitaskTaskMixin

    specs = MultitaskTaskMixin.aux_task_specs(types.SimpleNamespace(multitask_tasks=tasks))
    torch.manual_seed(19)
    with torch.device("cuda"):
        return NARS2UTModule(n_frames_per_step=OPT_K, multitask=specs,
                             ctc_vocab=len(OPT_LETTERS) + 4, target_speaker_embed=True,
                             speaker_embed_dim=OPT_SPK_DIM, **kw)


def run_options_train(torch, mods, tasks, smi):
    """Phase 19, training: one update at phase 10's CVSS shape and one in
    long form, each through the kernels and through the plain versions from
    one initialization and one set of generators (attention dropout 0), with
    the loss, gradient norm and every aux term held to phase 10's bounds;
    the flash_attention launches per long-form forward (training and
    validation). Returns the launches of the kernel runs."""
    import numpy as np

    from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(190)
    hi = NAR_MAX_TOKENS // NAR_B
    cvss = options_batch(rng, tasks, np.sort(rng.integers(300, hi + 1, NAR_B))[::-1],
                         rng.integers(100, 251, NAR_B).tolist())
    long = options_batch(rng, tasks, [LONG_FRAMES, LONG_FRAMES // 2], [600, 300])
    terms = ["loss", "gnorm", "nll_loss", "ctc_loss"] + [f"multitask_{n}_loss" for n in tasks]
    launches = 0
    for what, batch in (("CVSS-shaped", cvss), ("long form", long)):
        runs = {}
        for version in ("kernels", "plain"):
            model = options_model(torch, tasks, attention_dropout=0.0)
            trainer = Trainer(TrainerConfig(**NAR_TRAIN), model,
                              NARSpeechToUnitLoss(0.2, multitask=tasks))
            with plain_versions(*mods) if version == "plain" else contextlib.nullcontext():
                # warm-up: a validation forward draws nothing and leaves the
                # statistics alone, so both runs still start alike
                trainer.valid_step(batch, torch.Generator(device="cuda").manual_seed(0))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _build.launch_counts.clear()
                t1 = time.perf_counter()
                mets = trainer.train_step([batch])
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t1)
                peak = torch.cuda.max_memory_allocated() / 1e9
                n_train = _build.launch_counts.get("flash_attention", 0)
                _build.launch_counts.clear()
                trainer.valid_step(batch, torch.Generator(device="cuda").manual_seed(0))
                n_valid = _build.launch_counts.get("flash_attention", 0)
                if what == "CVSS-shaped":
                    # the first update of a process pays one-time costs: time a
                    # second, and profile a third
                    t1 = time.perf_counter()
                    trainer.train_step([batch])
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t1)
                    if version == "kernels":
                        profile_run(torch, lambda: trainer.train_step([batch]), ms / 1e3)
            runs[version] = (mets, ms, peak, n_train, n_valid)
            del model, trainer
        (mk, ms_k, peak_k, n_train, n_valid), (mp, ms_p, _, _, _) = runs["kernels"], runs["plain"]
        want = OPT_FLASH_PER_FORWARD if what == "long form" else 0
        if n_train != want or n_valid != want:
            fail(f"options train {what}: flash_attention launched {n_train} times in the training "
                 f"forward and {n_valid} in validation, expected {want} each")
        launches += n_train + n_valid
        rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in terms}
        if not all(math.isfinite(mk[k]) for k in terms):
            fail(f"options train {what}: non-finite metrics {mk}")
        bad = {k: v for k, v in rel.items()
               if v > (TRAIN_GNORM_REL if k == "gnorm" else TRAIN_LOSS_REL)}
        if bad:
            fail(f"options train {what}: kernels against plain versions {bad}")
        b, t = batch["src_tokens"].shape[:2]
        which = "the second update" if what == "CVSS-shaped" else "the first update"
        print(f"options train {what}: B{b} x {t} padded frames, {batch['target'].shape[1]} "
              f"packed steps x {OPT_K}, aux heads {list(tasks)}, the CTC head and 256-d "
              f"speakers, bf16 forward: {which} {ms_k:.1f} ms (plain versions {ms_p:.1f} ms), "
              f"peak {peak_k:.2f} GB; " + ", ".join(f"{k} {mk[k]:.5f}" for k in terms)
              + "; rel to the plain-version run " + ", ".join(f"{k} {v:.2e}"
                                                              for k, v in rel.items())
              + f"; flash_attention launches per forward: training {n_train}, validation "
              f"{n_valid}; {smi}")
    return launches


def options_decode_model(torch, tasks):
    """The options model in bf16 eval mode, its sub-frame output rows of the
    specials zeroed and the unit rows scaled by 10 (s2st_models' move), so
    the decode emits varied units."""
    nar = options_model(torch, tasks)
    with torch.no_grad():
        w = nar.decoder.subframe_out.weight
        w[:4] = 0.0
        w[4:] *= 10.0
    return nar.to(torch.bfloat16).eval()


def run_options_decode(torch, nar, mods, smi):
    """Phase 19, decode: mask_predict_decode of the stacked,
    speaker-conditioned model at B16 x 480 and B2 x 8448 through the kernels
    and through the plain versions (units equal at CVSS length, phase 6's
    share in long form). Returns the launches of the kernel runs."""
    import numpy as np

    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.ops import _build

    launches = 0
    for what, b, frames in (("CVSS length", S2ST_B, S2ST_FRAMES),
                            ("long form", LONG_B, LONG_FRAMES)):
        src, lengths = s2st_inputs(torch, b, frames)
        spk = torch.from_numpy(np.random.default_rng(191).normal(
            size=(b, OPT_SPK_DIM)).astype(np.float32)).cuda()
        kw = dict(max_iter=S2ST_KW["max_iter"], max_len=S2ST_KW["max_len"], tgt_speaker=spk)
        mask_predict_decode(nar, src, lengths, **kw)  # warm-up
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t1 = time.perf_counter()
        tokens, _, steps = mask_predict_decode(nar, src, lengths, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n_flash = _build.launch_counts.get("flash_attention", 0)
        launches += n_flash
        with plain_versions(*mods):
            ref, _, _ = mask_predict_decode(nar, src, lengths, **kw)
        forwards = int(steps.max())
        want = nar.decoder.n_layers * forwards if frames == LONG_FRAMES else 0
        if n_flash < want or (not want and n_flash):
            fail(f"options decode {what}: flash_attention launched {n_flash} times for "
                 f"{forwards} decoder forwards")
        units = (tokens >= 4) & (ref >= 4)
        agree = ((tokens == ref) & units).sum().item() / max(units.sum().item(), 1)
        if tokens.shape != (b, S2ST_KW["max_len"] * OPT_K) or (tokens >= 1004).any():
            fail(f"options decode {what}: tokens {tuple(tokens.shape)} out of range")
        if (what == "CVSS length" and not torch.equal(tokens, ref)) or agree < LONG_UNIT_AGREE:
            fail(f"options decode {what}: against the plain-version run, share of equal "
                 f"units {agree:.4f}")
        print(f"options decode {what}: B{b} x {frames} frames, k {OPT_K}, 256-d speakers, bf16: "
              f"wall {wall:.4f} s, iterations per row {steps.tolist()}, units per row "
              f"{(tokens >= 4).sum(1).tolist()}, flash_attention launches {n_flash}; against "
              f"the plain-version run {'equal' if torch.equal(tokens, ref) else 'differ'} "
              f"(share of equal units {agree:.4f}); {smi}")
    return launches


def run_options_s2st(torch, nar, smi):
    """Phase 19, S2ST: s2st_generate of the options model with the released
    code-HiFi-GAN made multi-speaker (OPT_SPEAKERS seeded speakers), each
    row its own speaker and target-speaker embedding, at B16 x 480: the
    median wall of 3 runs and the RTF."""
    import numpy as np

    from diffnorm_tpu_torch.generate.s2st import s2st_generate
    from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder

    torch.manual_seed(192)
    voc = CodeHiFiGANVocoder.from_config(dict(VOCODER_CFG, multispkr=True,
                                              num_speakers=OPT_SPEAKERS),
                                         device="cuda", dtype=torch.bfloat16).module
    src, lengths = s2st_inputs(torch, S2ST_B, S2ST_FRAMES)
    spk = torch.from_numpy(np.random.default_rng(193).normal(
        size=(S2ST_B, OPT_SPK_DIM)).astype(np.float32)).cuda()
    spkr = torch.arange(S2ST_B, device="cuda") * 7 % OPT_SPEAKERS
    walls = []
    for _ in range(4):  # a warm-up, then 3 timed
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wav, wav_lengths, units, counts, steps = s2st_generate(
            nar, voc, src, lengths, tgt_speaker=spk, spkr=spkr, **S2ST_KW)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = statistics.median(walls[1:])
    n_wav = S2ST_KW["max_wav_units"] * voc.upsample
    if wav.shape != (S2ST_B, n_wav) or not torch.isfinite(wav.float()).all() or \
            counts.min() < 1:
        fail(f"options S2ST: waveform {tuple(wav.shape)} (finite: "
             f"{bool(torch.isfinite(wav.float()).all())}), unit counts {counts.tolist()}")
    audio_s = S2ST_B * S2ST_FRAMES * SECONDS_PER_FRAME
    print(f"options S2ST: B{S2ST_B} x {S2ST_FRAMES} frames, stacked and speaker-conditioned "
          f"NAR, multi-speaker vocoder ({OPT_SPEAKERS} speakers, one per row), bf16: wall "
          f"{wall:.4f} s (median of 3), RTF {audio_s / wall:.2f}, unit counts "
          f"{counts.tolist()}; {smi}")
    del voc


def run_options_cli(torch, smi):
    """Phase 19, the CLIs: cli.train for 2 updates on phase 11's corpus with
    a speaker directory and the aux tasks' letter targets (every option's
    flag), then cli.generate on the step directory: its H- units equal an
    in-process decode of the same weights and batches. Returns cli.generate's
    flash_attention launches."""
    import numpy as np

    from diffnorm_tpu_torch.cli import generate
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli.generate import strip_special
    from diffnorm_tpu_torch.cli.s2st import build_model
    from diffnorm_tpu_torch.data.dictionary import Dictionary
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.data.manifest import read_translation_manifest
    from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_nar_corpus(tmp)
        rng = np.random.default_rng(194)
        units = {}
        (tmp / "spk").mkdir()
        for split in ("train", "dev", "test"):
            rows = read_translation_manifest(str(tmp / f"{split}.tsv"))
            units[split] = {r["id"]: int(r["tgt_n_frames"]) for r in rows}
            lines = ["id\tspeaker_embed"]
            for r in rows:
                np.save(tmp / "spk" / f"{r['id']}.npy",
                        rng.normal(size=(OPT_SPK_DIM,)).astype(np.float32))
                lines.append(f"{r['id']}\t{r['id']}.npy")
            (tmp / "spk" / f"{split}.tsv").write_text("\n".join(lines) + "\n")
        with open(tmp / "config.yaml", "a") as f:
            f.write("target_speaker_embed: spk\n")
        write_options_data(tmp, rng, {s: units[s] for s in ("train", "dev")})
        options = ["--n-frames-per-step", str(OPT_K), "--target-speaker-embed",
                   "--speaker-embed-dim", str(OPT_SPK_DIM)]
        save_dir = tmp / "nar"
        args = [str(tmp), "--task", "speech_to_speech_fasttranslate", "--target-code-size",
                "1000", "--arch", "nar_s2ut_conformer", "--save-dir", str(save_dir),
                "--lr", "5e-4", "--warmup-updates", "10000", "--clip-norm", "10.0",
                "--max-update", "2", "--max-tokens", "8000", "--max-target-positions", "1024",
                "--seed", "42", "--validate-interval", "5", "--save-interval", "5",
                "--dtype", "bfloat16", "--log-interval", "1", "--multitask-config-yaml",
                "multitask.yaml", "--multitask-ctc-vocab", str(len(OPT_LETTERS) + 4), *options,
                *EVAL_WIDTH_FLAGS]
        lines = LogLines()
        logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if train_cli.main(args) != 0:
            fail("options cli.train failed")
        train_s = time.perf_counter() - t0
        logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
        log = "\n".join(lines.lines)
        missing = [n for n in ["saved checkpoint at step 2", "valid |", "| step"]
                   + [f"multitask_{name}_loss" for name, *_ in OPT_TASKS] if n not in log]
        if missing:
            fail(f"options cli.train: log lacks {missing}")
        steps = [line for line in lines.lines if "| step" in line]
        step_dir = save_dir / "step_000000002"
        out = tmp / "gen"
        gen_args = [str(tmp), "--path", str(step_dir), "--gen-subset", "test",
                    "--max-tokens", str(EVAL_MAX_TOKENS), "--iter-decode-max-iter",
                    str(EVAL_MAX_ITER), *options, *EVAL_WIDTH_FLAGS]
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = generate.main(gen_args + ["--results-path", str(out)])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = _build.launch_counts.get("flash_attention", 0)
        if rc != 0:
            fail(f"options cli.generate returned {rc}")
        got = read_hyps(out / "generate-test.txt")
        gargs = generate.parse_args(gen_args)
        nar = build_model(gargs, str(step_dir), torch.device("cuda"), torch.bfloat16)
        tgt_dict = Dictionary.unit_dictionary(1000)
        ds = SpeechToUnitDataset.from_tsv(str(tmp), "test", tgt_dict=tgt_dict)
        want = {}
        for batch in EpochBatchIterator(ds, EVAL_MAX_TOKENS, shuffle=False).next_epoch_itr():
            tokens, _, _ = mask_predict_decode(
                nar, torch.from_numpy(batch["src_tokens"]).cuda(),
                torch.from_numpy(batch["src_lengths"]).cuda(), max_iter=EVAL_MAX_ITER,
                max_len=256, tgt_speaker=torch.from_numpy(batch["tgt_speaker"]).cuda())
            for row, sid in zip(tokens.cpu().numpy(), batch["id"].tolist()):
                want[sid] = strip_special(row, tgt_dict)
        if got != want:
            fail(f"options cli.generate: H- units differ from the in-process decode on "
                 f"{sorted(k for k in want if got.get(k) != want[k])}")
        print(f"phase options entry points: cli.train {train_s:.2f} s for 2 updates (released "
              f"widths, bf16, every option's flag, 24 WAV utterances of 3-7 s; last step: "
              f"{steps[-1]}); cli.generate {gen_s:.2f} s, its H- units (units per line "
              f"{[len(u.split()) for _, u in sorted(got.items())]}) equal an in-process "
              f"decode; {smi}")
    return launches


def run_options(torch, mods, smi):
    """Phase 19: the NAR model's options at the released widths (see the
    module docstring). Returns the flash_attention launches."""
    from diffnorm_tpu_torch.data.multitask import MultitaskConfig

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        import numpy as np

        tasks = MultitaskConfig(str(write_options_data(
            Path(tmp), np.random.default_rng(195)))).get_all_tasks()
        launches = run_options_train(torch, mods, tasks, smi)
        nar = options_decode_model(torch, tasks)
    launches += run_options_decode(torch, nar, mods, smi)
    run_options_s2st(torch, nar, smi)
    del nar
    launches += run_options_cli(torch, smi)
    print(f"phase options: {time.perf_counter() - t0:.1f} s")
    return launches


def timed_decode(torch, fn, reps: int = EXTRAS_REPS, warm=None):
    """fn() after a warm-up, warm() where given (a shorter call through the
    same code, say a decode cut to a few steps), else fn(). Returns (the
    output of a run with the launch counts set to 0 just before it, the
    counts read just after it, the median wall of `reps` runs with that
    one)."""
    from diffnorm_tpu_torch.ops import _build

    (warm or fn)()
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = dict(_build.launch_counts)
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, counts, statistics.median(walls)


def timed_updates(torch, trainer, batches, what):
    """ms of each update of `trainer` over `batches` (the first a warm-up),
    the peak GB and each update's metrics; fails on a loss or gradient norm
    that is not finite."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, mets = [], []
    for batch in batches:
        t1 = time.perf_counter()
        mets.append(trainer.train_step([batch]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        if not (math.isfinite(mets[-1]["loss"]) and math.isfinite(mets[-1]["gnorm"])):
            fail(f"{what} update: {mets[-1]}")
    return ms, torch.cuda.max_memory_allocated() / 1e9, mets


def unit_agreement(a, b) -> float:
    """The share of positions where two decodes' tokens agree, over the
    positions either one fills."""
    used = (a != 1) | (b != 1)
    return ((a == b) & used).sum().item() / max(used.sum().item(), 1)


def run_decode_extras(torch, mods, smi):
    """Phase 20, the decode extras: a 2-member ensemble at the S2ST cell's
    two shapes (see the module docstring), then cli.generate --path a:b
    --retain-iter-history --decode-chunk 4 on phase 15's corpus. Returns the
    flash_attention launches of the counted runs."""
    from diffnorm_tpu_torch.cli import generate
    from diffnorm_tpu_torch.cli.generate import strip_special
    from diffnorm_tpu_torch.data.dictionary import Dictionary
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
    from diffnorm_tpu_torch.generate.mask_predict import (
        mask_predict_decode,
        mask_predict_decode_chunked,
    )
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    t0 = time.perf_counter()
    members = [seeded_nar(torch, seed) for seed in range(EXTRAS_MEMBERS)]
    per_forward = EXTRAS_MEMBERS * members[0].decoder.n_layers
    kw = {k: S2ST_KW[k] for k in ("max_iter", "max_len")}
    n_flash = 0
    for what, b, frames in (("CVSS length", S2ST_B, S2ST_FRAMES),
                            ("long form", LONG_B, LONG_FRAMES)):
        inputs = s2st_inputs(torch, b, frames)
        long_form, chunk = frames == LONG_FRAMES, EXTRAS_CHUNK[frames]
        audio_s = b * frames * SECONDS_PER_FRAME
        one, _, single = timed_decode(torch, lambda: mask_predict_decode(members[0], *inputs, **kw))
        ens, counts, wall = timed_decode(torch, lambda: mask_predict_decode(members, *inputs, **kw))
        forwards = int(ens[2].max())
        flash = counts.get("flash_attention", 0)
        if flash != (per_forward * forwards if long_form else 0):
            fail(f"decode extras {what}: flash_attention launched {flash} times for {forwards} "
                 f"forwards of {EXTRAS_MEMBERS} members")
        with plain_versions(*mods):
            plain, plain_counts, plain_wall = timed_decode(
                torch, lambda: mask_predict_decode(members, *inputs, **kw), reps=1)
        agree_plain = unit_agreement(ens[0], plain[0])
        if plain_counts.get("flash_attention", 0) or (
                agree_plain < LONG_UNIT_AGREE if long_form else not torch.equal(ens[0], plain[0])):
            fail(f"decode extras {what}: the plain-version run, share equal {agree_plain:.4f}, "
                 f"launches {plain_counts}")
        hist_out, hist_counts, hist_wall = timed_decode(
            torch, lambda: mask_predict_decode_chunked(members, *inputs, chunk=chunk,
                                                       retain_history=True, **kw), reps=1)
        tokens, _, _, history = hist_out
        hist_flash = hist_counts.get("flash_attention", 0)
        want = per_forward * (kw["max_iter"] + 1) * -(-b // chunk) if long_form else 0
        if history.shape != (kw["max_iter"] + 1, b, kw["max_len"]) or not torch.equal(
                history[-1], tokens) or hist_flash != want:
            fail(f"decode extras {what}: history {tuple(history.shape)}, last step equal "
                 f"{torch.equal(history[-1], tokens)}, flash_attention {hist_flash} (want {want})")
        agree_chunk = unit_agreement(tokens, ens[0])
        if agree_chunk < EXTRAS_CHUNK_AGREE:
            fail(f"decode extras {what}: chunked against unchunked, share equal {agree_chunk:.4f}")
        n_flash += flash + hist_flash
        print(f"decode extras {what}: B{b}x{frames} frames, {EXTRAS_MEMBERS}-member ensemble, "
              f"bf16: wall {wall:.4f} s (median of {EXTRAS_REPS}), RTF {audio_s / wall:.2f}, "
              f"one member {single:.4f} s (RTF {audio_s / single:.2f}, ensemble "
              f"{wall / single:.2f}x, {int(one[2].max())} forwards), decoder forwards "
              f"{forwards}, flash_attention {flash}; "
              f"plain versions {plain_wall:.4f} s, units share equal {agree_plain:.4f}; "
              f"--decode-chunk {chunk} with the history {hist_wall:.4f} s, "
              f"{kw['max_iter'] + 1} forwards a chunk, flash_attention {hist_flash}, units "
              f"against the unchunked decode share equal {agree_chunk:.4f}; {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_eval_corpus(tmp)
        paths = []
        for i, m in enumerate(members):
            paths.append(str(tmp / f"nar{i}.npz"))
            save_npz(paths[-1], to_jax_variables(m))
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t1 = time.perf_counter()
        rc = generate.main([str(tmp), "--path", ":".join(paths), "--gen-subset", "test",
                            "--max-tokens", str(EVAL_MAX_TOKENS), "--iter-decode-max-iter",
                            str(EVAL_MAX_ITER), "--retain-iter-history", "--decode-chunk", "4",
                            "--results-path", str(tmp / "res"), *EVAL_WIDTH_FLAGS])
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t1
        cli_flash = _build.launch_counts.get("flash_attention", 0)
        if rc != 0:
            fail(f"decode extras: cli.generate --path a:b returned {rc}")
        lines = (tmp / "res" / "generate-test.txt").read_text().splitlines()
        got_h = read_hyps(tmp / "res" / "generate-test.txt")
        got_e = [line for line in lines if line.startswith("E-")]
        tgt_dict = Dictionary.unit_dictionary(1000)
        ds = SpeechToUnitDataset.from_tsv(str(tmp), "test", tgt_dict=tgt_dict)
        want_h, want_e = {}, []
        for batch in EpochBatchIterator(ds, EVAL_MAX_TOKENS, shuffle=False).next_epoch_itr():
            toks, _, _, hist = mask_predict_decode_chunked(
                members, torch.from_numpy(batch["src_tokens"]).cuda(),
                torch.from_numpy(batch["src_lengths"]).cuda(), chunk=4, retain_history=True,
                max_iter=EVAL_MAX_ITER, max_len=256)
            toks, hist = toks.cpu().numpy(), hist.cpu().numpy()
            for row, sid in enumerate(batch["id"].tolist()):
                want_h[sid] = strip_special(toks[row], tgt_dict)
                want_e += [f"E-{sid}_{st}\t{strip_special(hist[st, row], tgt_dict)}"
                           for st in range(hist.shape[0])]
        if got_h != want_h or sorted(got_e) != sorted(want_e):
            bad = [i for i in want_h if want_h[i] != got_h.get(i)]
            fail(f"decode extras: cli.generate's H- units (ids {bad} differ) or E- lines "
                 f"({len(got_e)} against {len(want_e)}) are not the in-process decode's")
        if cli_flash < per_forward * (EVAL_MAX_ITER + 1):
            fail(f"decode extras: cli.generate launched flash_attention {cli_flash} times")
    n_flash += cli_flash
    print(f"decode extras entry point: cli.generate --path a:b --retain-iter-history "
          f"--decode-chunk 4 on phase 15's {EVAL_SHORT + 1} sources: {cli_wall:.2f} s with both "
          f"members' load, H- units and {len(got_e)} E- lines equal to an in-process ensemble "
          f"decode, flash_attention {cli_flash}; {smi}")
    print(f"phase decode extras: {time.perf_counter() - t0:.1f} s")
    return n_flash


def run_remat(torch, smi):
    """Phase 20, encoder_remat: one long-form NAR update (phase 10's long
    batch shape, dropout 0.1) without and with remat, each after a
    validation warm-up: ms, peak memory, loss and gradient norm, the
    BatchNorm running statistics and the dropout, CG and SP generators'
    states after the update; then a second update's ms."""
    import numpy as np

    from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
    from diffnorm_tpu_torch.models.conformer import BatchNorm
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
    from diffnorm_tpu_torch.train.trainer import GENERATORS, Trainer, TrainerConfig

    t0 = time.perf_counter()
    long = nar_batch(np.random.default_rng(201), [LONG_FRAMES, LONG_FRAMES // 2], [600, 300])
    runs = {}
    for remat in (False, True):
        torch.manual_seed(12)
        with torch.device("cuda"):
            model = NARS2UTModule(encoder_remat=remat)
        trainer = Trainer(TrainerConfig(**NAR_TRAIN), model, NARSpeechToUnitLoss(0.2))
        trainer.valid_step(long, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        mets = trainer.train_step([long])
        torch.cuda.synchronize()
        ms = [1e3 * (time.perf_counter() - t1)]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = [m._buffers[k].clone() for m in model.modules() if isinstance(m, BatchNorm)
                 for k in BatchNorm.STATS]
        gens = [getattr(trainer, name).get_state() for name in GENERATORS]
        t1 = time.perf_counter()
        mets2 = trainer.train_step([long])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        runs[remat] = (mets, mets2, ms, peak_gb, stats, gens)
        del model, trainer
        torch.cuda.empty_cache()
    (m0, m0b, ms0, gb0, s0, g0), (m1, m1b, ms1, gb1, s1, g1) = runs[False], runs[True]
    loss_rel = abs(m1["loss"] - m0["loss"]) / abs(m0["loss"])
    gnorm_rel = abs(m1["gnorm"] - m0["gnorm"]) / abs(m0["gnorm"])
    stats_equal = all(torch.equal(a, b) for a, b in zip(s0, s1))
    gens_equal = all(torch.equal(a, b) for a, b in zip(g0, g1))
    line = (f"encoder_remat: long-form NAR update (B2 x {LONG_FRAMES}, dropout 0.1, bf16): "
            f"without remat {ms0[0]:.1f} / {ms0[1]:.1f} ms (first / second update), peak "
            f"{gb0:.2f} GB; with remat {ms1[0]:.1f} / {ms1[1]:.1f} ms, peak {gb1:.2f} GB; loss "
            f"{m0['loss']:.6f} / {m1['loss']:.6f} (rel {loss_rel:.2e}, bound {REMAT_LOSS_REL}), "
            f"gnorm rel {gnorm_rel:.2e} (bound {REMAT_GNORM_REL}), second update loss rel "
            f"{abs(m1b['loss'] - m0b['loss']) / abs(m0b['loss']):.2e}; BatchNorm running "
            f"statistics {'equal' if stats_equal else 'DIFFER'} ({len(s0)} tensors), generator "
            f"states {'equal' if gens_equal else 'DIFFER'}; {smi}")
    if (loss_rel > REMAT_LOSS_REL or gnorm_rel > REMAT_GNORM_REL or not stats_equal
            or not gens_equal or gb1 >= gb0):
        fail(line)
    print(line)
    print(f"phase encoder_remat: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def timed_calls(targets):
    """Each (owner, attribute) callable patched to append each call's wall
    time to totals["Owner.attribute"]."""
    totals, saved = {}, []
    for owner, name in targets:
        fn, key = getattr(owner, name), f"{owner.__name__}.{name}"
        totals[key] = []

        def wrapped(*args, _fn=fn, _key=key, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                totals[_key].append(time.perf_counter() - t0)

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield totals
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def write_noise_dir(root: Path, seed: int = 202):
    """AUG_NOISES seeded 16 kHz noise WAVs of 1-3 s."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for i in range(AUG_NOISES):
        n = int(rng.uniform(1.0, 3.0) * SAMPLE_RATE)
        write_wav_pcm(root / f"noise{i}.wav", (rng.normal(size=n) * 2000).astype(np.int16))


def update_ms(walls) -> str:
    return "ms per update " + " / ".join(f"{1e3 * w:.1f}" for w in walls) + " (the first warms up)"


def host_shares(totals, wall, update_key, transform_keys):
    """Each update's ms, and the transforms' seconds over the CLI's wall and
    over its host time outside the updates."""
    transforms_s = sum(sum(totals[k]) for k in transform_keys)
    outside = max(wall - sum(totals[update_key]), 1e-9)
    return (f"{update_ms(totals[update_key])}, transforms {1e3 * transforms_s:.1f} ms = "
            f"{100 * transforms_s / wall:.2f}% of the {wall:.2f} s wall and "
            f"{100 * transforms_s / outside:.2f}% of its host time outside the updates ("
            + ", ".join(f"{k} {1e3 * sum(v):.1f} ms / {len(v)} calls" for k, v in totals.items())
            + ")")


def run_augments(torch, smi):
    """Phase 20, the augments: cli.train (NAR, released widths, bf16) on
    phase 11's corpus with concataugment and SpecAugment for 2 updates, then
    cli.train_vocoder --data-config with noise, babble, sporadic noise and
    noisyoverlapaugment at scripts/full_recipe.sh's B32 x 28 units for 2
    updates (TF32 on for its cuDNN convs, the CLI's default): ms per update
    and the transforms' share of the host time."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli import train_vocoder
    from diffnorm_tpu_torch.data.audio import SpecAugment
    from diffnorm_tpu_torch.data.augment import ConcatAugment, NoiseAugment, NoisyOverlapAugment
    from diffnorm_tpu_torch.data.code_dataset import CodeToSpeechDataset
    from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
    from diffnorm_tpu_torch.train.gan_trainer import GanTrainer
    from diffnorm_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    lines = LogLines()
    logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
    logging.getLogger("diffnorm_tpu_torch.train_vocoder").addHandler(lines)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for d in ("noise", "nar", "voc"):
            (tmp / d).mkdir()
        write_noise_dir(tmp / "noise")
        write_nar_corpus(tmp / "nar")
        with open(tmp / "nar" / "config.yaml", "a") as f:
            f.write("dataset_transforms:\n  _train: [concataugment]\n"
                    "concataugment:\n  rate: 0.5\n  max_tokens: 1400\n")
        args = [str(tmp / "nar"), "--task", "speech_to_speech_fasttranslate",
                "--target-code-size", "1000", "--save-dir", str(tmp / "nar_ckpt"),
                "--max-update", "2", "--max-tokens", "8000", "--max-target-positions", "1024",
                "--seed", "42", "--dtype", "bfloat16", "--log-interval", "1",
                "--validate-interval", "5", "--save-interval", "5", *EVAL_WIDTH_FLAGS]
        keys = ["ConcatAugment.find_indices", "SpecAugment.__call__"]
        with timed_calls([(Trainer, "train_step"), (SpeechToUnitDataset, "__getitem__"),
                          (ConcatAugment, "find_indices"), (SpecAugment, "__call__")]) as totals:
            t1 = time.perf_counter()
            if train_cli.main(args) != 0 or "saved checkpoint at step 2" not in " ".join(
                    lines.lines):
                fail(f"augments: cli.train with concataugment: {lines.lines[-3:]}")
            wall = time.perf_counter() - t1
        if not totals["ConcatAugment.find_indices"]:
            fail("augments: cli.train drew no concataugment partner")
        print(f"augments cli.train NAR (concataugment rate 0.5 + SpecAugment, released widths, "
              f"bf16): {host_shares(totals, wall, 'Trainer.train_step', keys)}; {smi}")

        write_vocoder_corpus(tmp / "voc", n_utts=AUG_VOCODER_UTTS)
        noise = str(tmp / "noise")
        (tmp / "aug.yaml").write_text(json.dumps({
            "waveform_transforms": {"_train": ["noiseaugment", "babbleaugment",
                                               "sporadicnoiseaugment"]},
            "noiseaugment": {"samples_path": noise}, "babbleaugment": {"samples_path": noise},
            "sporadicnoiseaugment": {"samples_path": noise},
            "dataset_transforms": {"_train": ["noisyoverlapaugment"]},
            "noisyoverlapaugment": {"noise_path": noise}}))
        keys = ["NoiseAugment.__call__", "NoisyOverlapAugment.__call__"]
        lines.lines.clear()
        torch.backends.cudnn.allow_tf32 = True
        with timed_calls([(GanTrainer, "train_step"), (CodeToSpeechDataset, "__getitem__"),
                          (CodeToSpeechDataset, "collater"), (NoiseAugment, "__call__"),
                          (NoisyOverlapAugment, "__call__")]) as totals:
            t1 = time.perf_counter()
            rc = train_vocoder.main([
                "--units-file", str(tmp / "voc" / "train.units"), "--audio-dir",
                str(tmp / "voc"), "--vocoder-cfg", str(tmp / "voc" / "voc.json"),
                "--save-dir", str(tmp / "voc_ckpt"), "--batch-size", "32", "--crop-units",
                str(GAN_CROP), "--max-update", "2", "--log-interval", "1", "--data-config",
                str(tmp / "aug.yaml")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        torch.backends.cudnn.allow_tf32 = False
        if rc != 0 or "vocoder training done at step 2" not in lines.lines:
            fail(f"augments: cli.train_vocoder --data-config: {lines.lines[-3:]}")
        if not all(totals[k] for k in keys):
            fail(f"augments: a transform never ran: {totals}")
        print(f"augments cli.train_vocoder --data-config (noise, babble, sporadic noise, noisy "
              f"overlap at their default rates; B32 x {GAN_CROP} units, TF32 on): "
              f"{host_shares(totals, wall, 'GanTrainer.train_step', keys)}; {smi}")
    logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
    logging.getLogger("diffnorm_tpu_torch.train_vocoder").removeHandler(lines)
    print(f"phase augments: {time.perf_counter() - t0:.1f} s")


def run_repr_to_speech(torch, smi):
    """Phase 20, repr_to_speech: cli.get_manifest and cli.prepare
    dump-features (a random full-size mHuBERT from seed 0, layer 11) on
    FEAT_UTTS WAVs of 1-2 s, then cli.train_vocoder --input-type features at
    the released generator widths with model_in_dim 768, B32 x FEAT_CROP
    frames (10,240 samples a row), 2 updates (TF32 on): ms per update, peak
    memory, and a profile of one more update of the CLI's trainer."""
    import numpy as np

    from diffnorm_tpu_torch.cli import get_manifest, prepare, train_vocoder
    from diffnorm_tpu_torch.models.hifigan import FeatureGenerator
    from diffnorm_tpu_torch.train.gan_trainer import GanTrainer

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "wavs").mkdir()
        rng = np.random.default_rng(203)
        for i in range(FEAT_UTTS):
            n = int(rng.uniform(1.0, 2.0) * SAMPLE_RATE)
            write_wav_pcm(tmp / "wavs" / f"f{i:02d}.wav", (rng.normal(size=n) * 3000).astype(np.int16))
        t1 = time.perf_counter()
        if get_manifest.main([str(tmp / "wavs"), "--dest", str(tmp / "audio.tsv")]) != 0 or \
                prepare.main(["dump-features", "--manifest", str(tmp / "audio.tsv"), "--layer",
                              str(PREP_LAYER), "--out-dir", str(tmp / "feat"), "--split",
                              "train"]) != 0:
            fail("repr_to_speech: cli.get_manifest / cli.prepare dump-features failed")
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t1
        cfg = {k: v for k, v in VOCODER_CFG.items() if k != "dur_predictor_params"}
        (tmp / "voc.json").write_text(json.dumps(dict(cfg, model_in_dim=768)))
        seen = {}
        step = GanTrainer.train_step

        def recording(self, batch):
            seen["trainer"], seen["batch"] = self, batch
            return step(self, batch)

        GanTrainer.train_step = recording
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.reset_peak_memory_stats()
        try:
            with timed_calls([(GanTrainer, "train_step")]) as totals:
                t1 = time.perf_counter()
                rc = train_vocoder.main([
                    "--input-type", "features", "--feat-manifest",
                    str(tmp / "feat" / "train.manifest.tsv"), "--audio-dir", str(tmp / "wavs"),
                    "--vocoder-cfg", str(tmp / "voc.json"), "--save-dir", str(tmp / "ckpt"),
                    "--batch-size", "32", "--crop-units", str(FEAT_CROP), "--max-update", "2",
                    "--log-interval", "1"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            trainer, batch = seen["trainer"], seen["batch"]
            if rc != 0 or not isinstance(trainer.gen, FeatureGenerator) or \
                    batch["features"].shape != (32, FEAT_CROP, 768):
                fail(f"repr_to_speech: cli.train_vocoder --input-type features returned {rc}, "
                     f"batch {({k: np.shape(v) for k, v in batch.items()})}")
            walls = totals["GanTrainer.train_step"]
            print(f"repr_to_speech: dump-features {dump_s:.2f} s ({FEAT_UTTS} WAVs of 1-2 s, the "
                  f"encoder's build included); cli.train_vocoder --input-type features B32 x "
                  f"{FEAT_CROP} frames ({FEAT_CROP * 320} samples a row), released generator "
                  f"widths, TF32 on: {update_ms(walls)}, peak {peak_gb:.2f} GB, the CLI "
                  f"{wall:.2f} s; {smi}")
            profile_run(torch, lambda: trainer.train_step(batch), walls[-1])
        finally:
            GanTrainer.train_step = step
            torch.backends.cudnn.allow_tf32 = False
    print(f"phase repr_to_speech: {time.perf_counter() - t0:.1f} s")


def run_s2st_extras(torch, mods, smi):
    """Phase 20: ensembles and the decode extras, encoder_remat, the
    augments and repr_to_speech (see the module docstring). Returns the
    flash_attention launches."""
    t0 = time.perf_counter()
    launches = run_decode_extras(torch, mods, smi)
    run_remat(torch, smi)
    run_augments(torch, smi)
    run_repr_to_speech(torch, smi)
    print(f"phase S2ST extras: {time.perf_counter() - t0:.1f} s")
    return launches


def cond_batches(torch, n, b, t, prompt_frames, seed):
    """n micro-batches of phase 8's kind (train_batches) at B x T with a
    768-d prompt of `prompt_frames` (ragged masks, the first row full) and
    an injected drop mask that drops a quarter of the rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for batch in train_batches(torch, n, seed, "ddpm", b, t):
        lengths = torch.randint(prompt_frames // 2, prompt_frames + 1, (b,), generator=g,
                                device="cuda")
        lengths[0] = prompt_frames
        mask = torch.arange(prompt_frames, device="cuda")[None] < lengths[:, None]
        batch["prompt"] = torch.randn(b, prompt_frames, 768, generator=g, device="cuda") \
            * mask[..., None]
        batch["prompt_mask"] = mask
        batch["inject_cg_drop"] = torch.arange(b, device="cuda") % 4 == 1
        out.append(batch)
    return out


def guidance_cos(torch, outs, refs):
    """The least row cosine of each denoiser output [B, T, latent] against
    its plain-version run."""
    return [round(torch.nn.functional.cosine_similarity(
        o.float().reshape(-1, o.shape[-1]), r.float().reshape(-1, r.shape[-1]),
        dim=-1).min().item(), 5) for o, r in zip(outs, refs)]


def kernel_sites(model):
    """The wavenet_chain and rms_norm_film launches one forward of `model`
    needs: a chain per WaveNet layer, a kernel per FiLM RMSNorm."""
    from diffnorm_tpu_torch.models.layers import RMSNorm
    from diffnorm_tpu_torch.models.wavenet import Wavenet

    return {"wavenet_chain": sum(m.layers for m in model.modules()
                                 if isinstance(m, Wavenet) and m.chain_kernel),
            "rms_norm_film": sum(1 for m in model.modules() if isinstance(m, RMSNorm)
                                 and m.to_gamma_beta is not None and m.gamma is None)}


def run_train_cond(torch, mods, smi):
    """Phase 21a: the prompt-conditioned normalizer (LatentDiffusionModule
    use_cond: resampler depth 2 with 64 latents, 768-d prompt, cross
    attention in every layer, FiLM condition 4096) at the released widths:
    COND_UPDATES bf16 updates at B x T with a COND_PROMPT-frame prompt, run
    twice from one init on the same injected draws and drop mask at dropout
    0, through the kernels and through the plain versions (loss and
    gradient norm per update held to TRAIN_LOSS_REL / TRAIN_GNORM_REL), ms
    and launches per update, peak memory, busy share; forward_with_cond_scale
    at 1 (equal to the conditioned forward) and 2 against the plain
    versions; then one update and one guided forward at a COND_LONG_PROMPT
    prompt. Returns the launches of the kernels' runs."""
    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    cfg = TrainerConfig(lr=1e-4, warmup_updates=10000, warmup_init_lr=1e-7,
                        adam_betas=(0.9, 0.98), clip_norm=2.0, dtype="bfloat16", seed=42)
    micros = cond_batches(torch, COND_UPDATES, B, T, COND_PROMPT, 81)
    total = {}

    def build():
        torch.manual_seed(21)
        with torch.device("cuda"):
            model = LatentDiffusionModule(use_cond=True)
        return model, Trainer(cfg, model, DDPMDiscreteLoss(), ("vae",))

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    runs = {}
    for version in ("kernels", "plain"):
        model, trainer = build()
        need = kernel_sites(trainer.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_update = []
        with plain_versions(*mods) if version == "plain" else contextlib.nullcontext():
            for u in range(COND_UPDATES):
                _build.launch_counts.clear()
                t1 = time.perf_counter()
                mets = trainer.train_step(micros[u:u + 1])
                torch.cuda.synchronize()
                per_update.append((mets, 1e3 * (time.perf_counter() - t1),
                                   dict(_build.launch_counts)))
        runs[version] = (per_update, torch.cuda.max_memory_allocated() / 1e9)
        if version == "kernels":
            for _, _, launches in per_update:
                count(launches)
                if any(launches.get(k, 0) < n for k, n in need.items()):
                    fail(f"train conditioned: an update launched {launches}, a forward "
                         f"needs {need}")
            wall = statistics.median(ms for _, ms, _ in per_update[1:]) / 1e3
            profile_run(torch, lambda: trainer.train_step(micros[:1]), wall)
            work = trainer.model
        del model, trainer
    worst_loss = worst_gnorm = 0.0
    for (mk, _, _), (mp, _, _) in zip(runs["kernels"][0], runs["plain"][0]):
        if not (math.isfinite(mk["loss"]) and math.isfinite(mk["gnorm"])):
            fail(f"train conditioned: non-finite loss or gradient norm {mk}")
        worst_loss = max(worst_loss, abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]))
        worst_gnorm = max(worst_gnorm, abs(mk["gnorm"] - mp["gnorm"]) / abs(mp["gnorm"]))
    if worst_loss > TRAIN_LOSS_REL or worst_gnorm > TRAIN_GNORM_REL:
        fail(f"train conditioned: kernels against plain versions, loss rel {worst_loss:.3e}, "
             f"gnorm rel {worst_gnorm:.3e}")
    per_update, peak_gb = runs["kernels"]
    print(f"train conditioned: B{B}xT{T}, prompt {COND_PROMPT} frames, bf16 forward, float32 "
          f"masters; losses {[round(m['loss'], 5) for m, _, _ in per_update]}, gnorms "
          f"{[round(m['gnorm'], 4) for m, _, _ in per_update]}; ms per update "
          f"{[round(ms, 1) for _, ms, _ in per_update]} (plain versions "
          f"{[round(ms, 1) for _, ms, _ in runs['plain'][0]]}); launches per update "
          f"{per_update[-1][2]} (a forward needs {kernel_sites(work)}); peak {peak_gb:.2f} GB; "
          f"against the plain-version run loss rel {worst_loss:.2e}, gnorm rel "
          f"{worst_gnorm:.2e}; {smi}")

    # classifier-free guidance, eval mode
    work.eval()
    den = work.denoiser
    g = torch.Generator(device="cuda").manual_seed(82)
    batch = micros[0]
    x = torch.randn(B, T, 128, generator=g, device="cuda", dtype=torch.bfloat16)
    times = torch.randint(1, 200, (B,), generator=g, device="cuda")
    mask = batch["reduce_target_lengths"][:, None] > torch.arange(T, device="cuda")[None]
    cond_kw = dict(prompt=batch["prompt"], prompt_mask=batch["prompt_mask"])
    with torch.no_grad():
        cond = den(x, times, mask, **cond_kw)
        if not torch.equal(den.forward_with_cond_scale(x, times, mask, cond_scale=1.0, **cond_kw),
                           cond):
            fail("forward_with_cond_scale at 1 differs from the conditioned forward")
        null = den(x, times, mask, cond_drop_prob=1.0, **cond_kw)
        guided = den.forward_with_cond_scale(x, times, mask, cond_scale=2.0, **cond_kw)
        with plain_versions(*mods):
            refs = (den(x, times, mask, **cond_kw),
                    den(x, times, mask, cond_drop_prob=1.0, **cond_kw),
                    den.forward_with_cond_scale(x, times, mask, cond_scale=2.0, **cond_kw))
    cos = guidance_cos(torch, (cond, null, guided), refs)
    if not (torch.isfinite(guided).all() and torch.equal(guided, null + (cond - null) * 2.0)
            and min(cos[:2]) >= COND_ROW_COS and cos[2] >= GUIDED_ROW_COS):
        fail(f"forward_with_cond_scale 2: row-cos of the conditioned, null and guided outputs "
             f"{cos} against the plain versions (bounds {COND_ROW_COS}, {GUIDED_ROW_COS})")

    # the long prompt: one update (training: the resampler's dropout 0.1) and
    # one guided forward (eval), each with its flash_attention launches
    long_batch = cond_batches(torch, 1, COND_LONG_B, T, COND_LONG_PROMPT, 83)
    model, trainer = build()
    _build.launch_counts.clear()
    t1 = time.perf_counter()
    mets = trainer.train_step(long_batch)
    torch.cuda.synchronize()
    long_ms = 1e3 * (time.perf_counter() - t1)
    long_launches = dict(_build.launch_counts)
    count(long_launches)
    if not math.isfinite(mets["loss"]):
        fail(f"train conditioned, long prompt: {mets}")
    trainer.model.eval()
    den = trainer.model.denoiser
    lb = long_batch[0]
    xl, tl = x[:COND_LONG_B], times[:COND_LONG_B]
    maskl = lb["reduce_target_lengths"][:, None] > torch.arange(T, device="cuda")[None]
    kw = dict(prompt=lb["prompt"], prompt_mask=lb["prompt_mask"], cond_scale=2.0)
    with torch.no_grad():
        _build.launch_counts.clear()
        guided_long = den.forward_with_cond_scale(xl, tl, maskl, **kw)
        guided_launches = dict(_build.launch_counts)
        count(guided_launches)
        with plain_versions(*mods):
            guided_long_ref = den.forward_with_cond_scale(xl, tl, maskl, **kw)
    cos_long = guidance_cos(torch, (guided_long,), (guided_long_ref,))[0]
    if cos_long < GUIDED_ROW_COS:
        fail(f"guided forward at a {COND_LONG_PROMPT}-frame prompt: row-cos {cos_long:.5f} "
             f"against the plain versions")
    del model, trainer, work
    print(f"train conditioned, guidance: forward_with_cond_scale 1 equals the conditioned "
          f"forward; against the plain versions row-cos {cos} for the conditioned, null and "
          f"scale-2 outputs (bounds {COND_ROW_COS}, {GUIDED_ROW_COS}). Prompt {COND_LONG_PROMPT} frames (64 latents + {COND_LONG_PROMPT} "
          f"= {64 + COND_LONG_PROMPT} keys), B{COND_LONG_B}xT{T}: one update {long_ms:.1f} ms, "
          f"launches {long_launches} (flash_attention "
          f"{long_launches.get('flash_attention', 0)}: the resampler's training dropout 0.1 "
          f"keeps it on the plain path); the guided forward (eval) launches "
          f"{guided_launches}, row-cos {cos_long:.5f}; {smi}")
    print(f"phase train conditioned: {time.perf_counter() - t0:.1f} s")
    return total


class StepTimer:
    """Times every Trainer.train_step (synchronised) while it is open."""

    def __init__(self, torch):
        from diffnorm_tpu_torch.train.trainer import Trainer

        self.torch, self.cls, self.ms = torch, Trainer, []

    def __enter__(self):
        step = self.orig = self.cls.train_step

        def timed(trainer, batches):
            self.torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(trainer, batches)
            self.torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t1))
            return out

        self.cls.train_step = timed
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig


def run_train_tasks_cli(torch, smi):
    """Phase 21b: cli.train at the released widths in bf16 with seeded
    weights on phase 9's corpus, 2 updates each: speech_diffusion
    (diff_latent), speech_diffusion_hubert (diff_hubert, no VAE), hubert_vae
    and speech_diffusion_discrete --arch diffusion_transformer. Returns the
    launches."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.ops import _build

    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        feat_dir = write_train_corpus(tmp)
        common = [str(tmp), "--tgt-feat-dir", str(feat_dir), "--target-code-size", "1000",
                  "--dropout", "0.1", "--lr", "1e-4", "--max-tokens", "1200",
                  "--max-update", "2", "--seed", "42", "--log-interval", "1",
                  "--dtype", "bfloat16"]
        runs = (("speech_diffusion", "diff_latent", "ddpm_latent_loss"),
                ("speech_diffusion_hubert", "diff_hubert", "ddpm_latent_loss"),
                ("hubert_vae", "speech_vae_decoder", "hubert_vae_loss"),
                ("speech_diffusion_discrete", "diffusion_transformer", "ddpm_discrete_loss"))
        for task, arch, criterion in runs:
            _build.launch_counts.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with StepTimer(torch) as timer:
                rc = train_cli.main(common + ["--task", task, "--arch", arch, "--criterion",
                                              criterion, "--save-dir", str(tmp / task)])
            dt = time.perf_counter() - t1
            launches = dict(_build.launch_counts)
            if rc != 0 or not (tmp / task / "step_000000002" / "params.npz").exists():
                fail(f"cli.train --task {task} --arch {arch}: rc {rc}")
            if not launches.get("wavenet_chain") or (
                    task != "hubert_vae" and not launches.get("rms_norm_film")):
                fail(f"cli.train --task {task}: launches {launches}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            print(f"phase entry point train ({task}, --arch {arch}): {dt:.2f} s for cli.train "
                  f"to step 2 (released widths, bf16, 24 utterances); ms per update "
                  f"{[round(ms, 1) for ms in timer.ms]}; launches {launches}; {smi}")
    return total


def run_optim_cli(torch, smi):
    """Phase 21c (first half): the normalizer (released widths,
    CLI_NORMALIZER's depth) through cli.train --optimizer adamax
    --lr-scheduler cosine --ema-decay 0.999, one batch per epoch: 3 updates, then --restore-file and 2 more in another
    directory, against a 5-update run: parameters, EMA and moments equal
    bit for bit."""
    import numpy as np

    from diffnorm_tpu_torch.cli import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        feat_dir = write_train_corpus(tmp)
        common = [str(tmp), "--tgt-feat-dir", str(feat_dir), "--target-code-size", "1000",
                  "--task", "speech_diffusion_discrete", "--arch", "diff_discrete",
                  "--dropout", "0.1", "--optimizer", "adamax", "--lr-scheduler", "cosine",
                  "--lr", "1e-4", "--warmup-updates", "2", "--ema-decay", "0.999",
                  "--max-tokens", "4096", "--seed", "42", "--log-interval", "1",
                  "--validate-interval", "100", "--save-interval", "100",
                  "--dtype", "bfloat16", *normalizer_flags(CLI_NORMALIZER)]
        walls = {}
        for what, max_update, extra in (
                ("straight", 5, []), ("first", 3, []),
                ("resumed", 5, ["--restore-file", str(tmp / "first" / "step_000000003")])):
            t1 = time.perf_counter()
            with StepTimer(torch) as timer:
                rc = train_cli.main(common + ["--save-dir", str(tmp / what), "--max-update",
                                              str(max_update), *extra])
            walls[what] = (round(time.perf_counter() - t1, 2), [round(m, 1) for m in timer.ms])
            if rc != 0:
                fail(f"cli.train adamax/cosine/EMA {what}: rc {rc}")
        a, b = tmp / "straight" / "step_000000005", tmp / "resumed" / "step_000000005"
        pa, pb = np.load(a / "params.npz"), np.load(b / "params.npz")
        sa = torch.load(a / "trainer.pt", map_location="cpu")
        sb = torch.load(b / "trainer.pt", map_location="cpu")
        differ = [k for k in pa.files if not np.array_equal(pa[k], pb[k])]
        differ += [f"ema {i}" for i, (x, y) in enumerate(zip(sa["ema"]["params"],
                                                              sb["ema"]["params"]))
                   if not torch.equal(x, y)]
        if differ or sa["optimizer"]["count"] != 5 or sb["num_updates"] != 5:
            fail(f"cli.train 3 + --restore-file 2 against 5 updates: {len(differ)} arrays "
                 f"differ ({differ[:5]})")
    print(f"phase entry point train (adamax, cosine, EMA 0.999; depth {CLI_NORMALIZER}): 3 "
          f"updates + --restore-file 2 equal a 5-update run bit for bit ({len(pa.files)} "
          f"parameter arrays and the EMA); "
          f"walls (s) and ms per update {walls}; {smi}")


def run_optim_devices(torch, smi):
    """Phase 21c (second half): each other optimizer under a schedule (the
    host-driven ones among them) on the card against the CPU, on a small
    no-VAE normalizer (dim 128, FiLM-conditioned WaveNet and transformer,
    the float32 kernels on the card): one Trainer update from one init on
    one batch, ||p_card - p_cpu|| / ||p_cpu - p_0|| <= OPTIM_DEVICE_REL;
    then 2 updates of the optimizer alone (unclipped) on the same seeded
    gradients, <= OPTIM_STEP_REL. (Two Trainer updates part further: the learned
    Fourier time embedding multiplies a weight's difference by 2 pi t, up to
    ~1250, PERF.md §6.)"""
    import numpy as np

    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMLatentLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.train.lr_schedules import build_lr_schedule
    from diffnorm_tpu_torch.train.optimizers import build_optimizer
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(84)
    lengths = np.asarray([32, 24, 17, 32], np.int32)
    mask = np.arange(32)[None] < lengths[:, None]
    batch = {"reduce_target": (rng.normal(size=(4, 32, 64)) * mask[..., None]).astype(np.float32),
             "reduce_target_lengths": lengths, "inject_times": rng.integers(1, 200, size=4),
             **{f"inject_{k}": rng.normal(size=(4, 32, 64)).astype(np.float32)
                for k in ("enc_noise", "x1_noise", "q_noise")}}
    widths = dict(dim=128, latent_dim=64, feature_dim=64, denoiser_depth=2, wavenet_layers=2,
                  wavenet_stacks=2, use_vae=False)
    torch.manual_seed(85)
    init = LatentDiffusionModule(**widths).state_dict()
    gen = torch.Generator().manual_seed(86)
    grads = [[torch.randn(v.shape, generator=gen) * 0.01 for v in init.values()]
             for _ in range(2)]

    def rel(finals, p0):
        moved = (finals["cpu"] - p0).norm().item()
        return (finals["cuda"] - finals["cpu"]).norm().item() / max(moved, 1e-30), moved

    results, worst = {}, []
    for name, options in OPTIM_CASES:
        opts = {k: v for k, v in options.items() if k not in ("lr", "lr_scheduler")}
        cfg = TrainerConfig(lr=options.get("lr", 1e-3), optimizer=name,
                            lr_scheduler=options["lr_scheduler"], clip_norm=1.0, options=opts,
                            seed=3)
        trained, stepped = {}, {}
        for device in ("cpu", "cuda"):
            with torch.device(device):
                model = LatentDiffusionModule(**widths)
            model.load_state_dict(init)
            Trainer(cfg, model, DDPMLatentLoss()).train_step([batch])
            trained[device] = torch.cat([p.detach().cpu().reshape(-1)
                                         for p in model.parameters()])
            params = [v.detach().to(device).clone() for v in init.values()]
            schedule = build_lr_schedule(cfg.optimization())
            opt = build_optimizer(cfg.optimization(), schedule, params, list(init))
            for i, g in enumerate(grads):
                lr = schedule.step_update(i) if getattr(schedule, "host_driven", False) else None
                opt.step([x.to(device) for x in g], lr)
            stepped[device] = torch.cat([p.cpu().reshape(-1) for p in params])
        p0 = torch.cat([v.reshape(-1) for v in init.values()])
        p0_trained = torch.cat([init[n].reshape(-1) for n, _ in model.named_parameters()])
        (r1, m1), (r2, m2) = rel(trained, p0_trained), rel(stepped, p0)
        key = f"{name}/{options['lr_scheduler']}"
        results[key] = f"update {r1:.2e} of {m1:.3e}, steps {r2:.2e} of {m2:.3e}"
        if not (m1 > 0 and m2 > 0 and r1 <= OPTIM_DEVICE_REL and r2 <= OPTIM_STEP_REL):
            worst.append(key)
    print(f"phase optimizers on the card: a small normalizer's float32 Trainer update and 2 "
          f"optimizer steps on seeded gradients, card against CPU, ||diff|| / ||change|| per "
          f"optimizer/schedule {results} (bounds {OPTIM_DEVICE_REL}, {OPTIM_STEP_REL}); {smi}")
    if worst:
        fail(f"optimizers on the card against the CPU beyond their bounds: {worst}")


def run_training_remainder(torch, mods, smi):
    """Phase 21: the prompt-conditioned normalizer, the continuous tasks
    through cli.train, and the optimizers and schedules (see the module
    docstring). Returns the kernels' launches."""
    t0 = time.perf_counter()
    launches = run_train_cond(torch, mods, smi)
    for k, v in run_train_tasks_cli(torch, smi).items():
        launches[k] = launches.get(k, 0) + v
    run_optim_cli(torch, smi)
    run_optim_devices(torch, smi)
    print(f"phase training remainder: {time.perf_counter() - t0:.1f} s; {smi}")
    return launches


# the recipe's last training options (phase 22): the loader's workers and
# read-ahead, sharded --data, --quant-int8 training, the int8 vocoder, and
# a JAX optimizer state through the bridge
LOADER_MAX_TOKENS = 3000      # ~5 of phase 11's 3-7 s utterances a batch
LOADER_WORKERS = 4
# a resumed run, and one with another worker count, repeat the uninterrupted
# run's batches and draws: its losses within this (float rounding only)
LOADER_LOSS_REL = 1e-5
DDIM_CLI_UTTS, DDIM_CLI_BATCH = 32, 8
LOADER_VOCODER_UTTS = 96      # 3 batches of the recipe's 32 an epoch
# --quant-int8 training: a bf16 update's gradient against the float32
# recompute of the same scale-only gradient (the int8 codes of bf16 and
# float32 activations differ where a value sits near a rounding boundary).
# Guessed 0.99 / 0.2 at first; the first chip run measured cos 0.9747, rel
# 0.2261 at the released width (PERF.md, PR 18), and the float model's own
# bf16-against-float32 agreement is printed beside it
INT8_TRAIN_GRAD_COS, INT8_TRAIN_GRAD_REL = 0.95, 0.35
VAE_CHAINS = 6  # the frozen VAE's WaveNet chains in a normalizer forward
# JAX's bounds of its int8 vocoder against the float one
# (tests/test_packed_vocoder.py:157-160)
INT8_VOCODER_REL = {"dynamic": 0.05, "static": 0.06}
VOCODER_REPS = 5
# the bridged optimizer state: the CLI's update against an in-process
# Trainer loaded with the same state, relative to the update's size
BRIDGE_UPDATE_REL = 1e-5


def write_nar_shards(root: Path):
    """Phase 11's corpus with its train split in two shard directories
    (halves, sources by absolute path), each with the dev split and a data
    config without SpecAugment (its draws come from one shared generator,
    whose order workers change)."""
    from diffnorm_tpu_torch.data.manifest import (
        read_translation_manifest,
        write_translation_manifest,
    )

    write_nar_corpus(root)
    rows = {split: read_translation_manifest(str(root / f"{split}.tsv"))
            for split in ("train", "dev")}
    for split_rows in rows.values():
        for row in split_rows:
            row["src_audio"] = str(root / row["src_audio"])
    half = len(rows["train"]) // 2
    shards = []
    for k, part in enumerate((rows["train"][:half], rows["train"][half:])):
        shard = root / f"shard{k}"
        shard.mkdir()
        write_translation_manifest(str(shard / "train.tsv"), part)
        write_translation_manifest(str(shard / "dev.tsv"), rows["dev"])
        (shard / "config.yaml").write_text("transforms:\n  '*': [utterance_cmvn]\n")
        shards.append(shard)
    return shards


def nar_cli_args(data: str, save_dir: Path) -> list:
    return [data, "--config-yaml", "config.yaml", "--task", "speech_to_speech_fasttranslate",
            "--target-code-size", "1000", "--criterion", "nar_speech_to_unit",
            "--label-smoothing", "0.2", "--arch", "nar_s2ut_conformer", "--dropout", "0.1",
            "--save-dir", str(save_dir), "--keep-last-epochs", "10", "--lr", "5e-4",
            "--lr-scheduler", "inverse_sqrt", "--warmup-init-lr", "1e-7", "--warmup-updates",
            "10000", "--adam-betas", "(0.9,0.98)", "--clip-norm", "10.0", "--max-tokens",
            str(LOADER_MAX_TOKENS), "--max-target-positions", "1024", "--seed", "42",
            "--validate-interval", "5", "--save-interval", "5", "--dtype", "bfloat16",
            "--log-interval", "1", *CLI_NAR_DEPTH]


@contextlib.contextmanager
def recorded_cli_run(task_cls):
    """The batch ids a cli.train run prepares for training (not for
    validation), in order, and each update's (loss, wall) and the first
    update's start and the last one's end."""
    import numpy as np

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.train.trainer import Trainer

    from diffnorm_tpu_torch.train.checkpoint import CheckpointManager

    rec = {"ids": [], "updates": [], "span": [], "saves": []}
    prepare, validate, step = task_cls.prepare_batch, train_cli.validate_split, Trainer.train_step
    save = CheckpointManager.save
    validating = []

    def timed_save(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return save(self, *args, **kwargs)
        finally:
            rec["saves"].append((t0, time.perf_counter()))

    def record_prepare(self, batch, rng):
        ids = [int(i) for i in batch["id"]]
        if not validating:
            rec["ids"].append(ids)
        # each batch's host draws (the CMLM canvas) from a generator of its
        # ids: a run restarts the CLI's generator at every start (JAX's
        # too), so a resumed run repeats the uninterrupted one's losses
        # only with the draws injected, as the other phases inject them
        return prepare(self, batch, np.random.default_rng(sum(ids) * 131 + len(ids)))

    def flagged(*args):
        validating.append(True)
        try:
            return validate(*args)
        finally:
            validating.clear()

    def timed_step(self, batches):
        t0 = time.perf_counter()
        mets = step(self, batches)  # ends in the metrics' copy to the host
        t1 = time.perf_counter()
        rec["updates"].append((mets["loss"], t1 - t0))
        rec["span"] = [rec["span"][0] if rec["span"] else t1, t1]  # from the first's end
        return mets

    task_cls.prepare_batch, train_cli.validate_split = record_prepare, flagged
    Trainer.train_step, CheckpointManager.save = timed_step, timed_save
    try:
        yield rec
    finally:
        task_cls.prepare_batch, train_cli.validate_split = prepare, validate
        Trainer.train_step, CheckpointManager.save = step, save


def host_share(rec) -> float:
    """The share of the training loop's wall outside the updates (loading,
    the batches' preparation and upload, logging) from the first update's
    end (which pays the process's warm-up) to the last one's, checkpoint
    saves left out."""
    start, end = rec["span"]
    saves = sum(b - a for a, b in rec.get("saves", []) if a >= start and b <= end)
    span = end - start - saves
    return 1.0 - sum(w for _, w in rec["updates"][1:]) / max(span, 1e-9)


def loss_rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def run_loader_nar(torch, smi):
    """Phase 22a: cli.train (the NAR at the released widths and
    CLI_NAR_DEPTH's depth, bf16) on phase 11's corpus
    in two shards over 2 epochs, each batch's canvas drawn from its ids:
    --num-workers 4 against 0 (the same batch lists, losses), each epoch's
    batches those of the iterator on its shard (the rotation rule), and a
    --restore-file resume from a mid-epoch checkpoint
    (--save-interval-updates 2) against the uninterrupted run."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.tasks.nar_s2ut_task import NARS2UTTask

    lines = LogLines()
    logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shards = write_nar_shards(tmp)
        data = ":".join(map(str, shards))
        task = NARS2UTTask(train_cli.parse_args(nar_cli_args(data, tmp / "x")
                                                + ["--max-update", "1"]))
        epochs = []
        for epoch in (1, 2):
            itr = EpochBatchIterator(task.dataset("train", epoch=epoch),
                                     max_tokens=LOADER_MAX_TOKENS, seed=42, num_prefetch=0,
                                     max_positions=(None, 1024), ignore_invalid_inputs=True)
            itr.epoch = epoch
            epochs.append([[int(i) for i in b["id"]] for b in itr.next_epoch_itr()])
        if len(epochs[0]) < 3:
            fail(f"loader NAR: epoch 1 has {len(epochs[0])} batches; a mid-epoch save needs 3")
        total = len(epochs[0]) + len(epochs[1])
        want = epochs[0] + epochs[1]
        runs = {}
        for what, extra in (("workers 0", ["--num-workers", "0"]),  # pays the cold start
                            ("workers 4", ["--num-workers", str(LOADER_WORKERS),
                                           "--save-interval-updates", "2"]),
                            ("resumed", ["--num-workers", str(LOADER_WORKERS), "--restore-file",
                                         str(tmp / "workers 4" / "step_000000002")])):
            lines.lines.clear()
            with recorded_cli_run(NARS2UTTask) as rec:
                t0 = time.perf_counter()
                if train_cli.main(nar_cli_args(data, tmp / what)
                                  + ["--max-update", str(total), *extra]) != 0:
                    fail(f"loader NAR cli.train ({what}) failed")
                rec["wall"] = time.perf_counter() - t0
            rec["log"] = list(lines.lines)
            runs[what] = rec
        logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
        side = json.loads((tmp / "workers 4" / "step_000000002.json").read_text())
    four, zero, resumed = runs["workers 4"], runs["workers 0"], runs["resumed"]
    n = len(four["updates"])
    if n != total or four["ids"][:total] != want or zero["ids"][:total] != want:
        fail(f"loader NAR: batches differ from the iterator's on each shard ({n} updates)")
    if resumed["ids"][:total - 2] != want[2:] or len(resumed["updates"]) != total - 2:
        fail("loader NAR: the resumed run did not start at the first untrained batch")
    if side["iterator"]["offset"] != 2 or side["epoch"] != 1:
        fail(f"loader NAR: the mid-epoch checkpoint recorded {side['iterator']}")
    shard_line = f"loaded data shard {shards[1]} for epoch 2"
    if not any(shard_line in line for line in four["log"]):
        fail(f"loader NAR: no '{shard_line}'")
    rel_workers = loss_rel([x for x, _ in zero["updates"]], [x for x, _ in four["updates"]])
    rel_resume = loss_rel([x for x, _ in resumed["updates"]], [x for x, _ in four["updates"][2:]])
    if rel_workers > LOADER_LOSS_REL or rel_resume > LOADER_LOSS_REL:
        fail(f"loader NAR: losses against the workers-4 run: workers 0 rel {rel_workers:.2e}, "
             f"resumed rel {rel_resume:.2e} (bound {LOADER_LOSS_REL})")
    for what, rec in runs.items():
        ms = [round(1e3 * w, 1) for _, w in rec["updates"]]
        print(f"loader NAR cli.train ({what}; {' '.join(CLI_NAR_DEPTH)}): "
              f"{rec['wall']:.2f} s, {len(ms)} updates over 2 "
              f"epochs of 2 shards (batches of <= {LOADER_MAX_TOKENS} frames), ms per update "
              f"{ms}, host share of the training loop after the first update "
              f"{100 * host_share(rec):.1f}% (checkpoint saves left out: "
              f"{sum(b - a for a, b in rec['saves']):.2f} s); {smi}")
    print(f"loader NAR: batch lists equal for workers 4 and 0 and the iterator's on each "
          f"shard ({[len(e) for e in epochs]} batches an epoch); the mid-epoch checkpoint at "
          f"offset 2 resumed at batch 3; losses against the workers-4 run: workers 0 rel "
          f"{rel_workers:.2e}, resumed rel {rel_resume:.2e} (bound {LOADER_LOSS_REL})")


def run_loader_vocoder(torch, smi):
    """Phase 22b: cli.train_vocoder at the recipe's B32 x 28 units on 96
    WAVs (3 batches an epoch), 6 updates, --num-workers 0 and 4: ms per
    update and the host share."""
    from diffnorm_tpu_torch.cli import train_vocoder
    from diffnorm_tpu_torch.train.gan_trainer import GanTrainer

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_vocoder_corpus(tmp, n_utts=LOADER_VOCODER_UTTS)
        base = ["--units-file", str(tmp / "train.units"), "--audio-dir", str(tmp),
                "--vocoder-cfg", str(tmp / "voc.json"), "--batch-size", str(GAN_B),
                "--crop-units", str(GAN_CROP), "--max-update", "6", "--log-interval", "3",
                "--save-interval-updates", "1000"]
        for workers in ("0", str(LOADER_WORKERS)):
            step = GanTrainer.train_step
            rec = {"updates": [], "span": []}

            def timed_step(self, batch, _step=step, _rec=rec):
                t0 = time.perf_counter()
                mets = _step(self, batch)
                t1 = time.perf_counter()
                _rec["updates"].append((0.0, t1 - t0))
                _rec["span"] = [_rec["span"][0] if _rec["span"] else t1, t1]
                return mets

            GanTrainer.train_step = timed_step
            try:
                t0 = time.perf_counter()
                if train_vocoder.main(base + ["--save-dir", str(tmp / workers),
                                              "--num-workers", workers]) != 0:
                    fail(f"cli.train_vocoder --num-workers {workers} failed")
                wall = time.perf_counter() - t0
            finally:
                GanTrainer.train_step = step
            ms = [round(1e3 * w, 1) for _, w in rec["updates"]]
            print(f"loader vocoder cli.train_vocoder --num-workers {workers}: {wall:.2f} s, "
                  f"B{GAN_B} x {GAN_CROP} units, ms per update {ms} (median of the last 5 "
                  f"{statistics.median(ms[1:]):.1f}), host share of the training loop after "
                  f"the first update {100 * host_share(rec):.1f}%; {smi}")


def run_loader_ddim(torch, smi):
    """Phase 22c: cli.diff_norm_synthesis (the normalizer at the released
    widths and CLI_NORMALIZER's depth, bf16)
    with its file prefetch on phase 9's 32 utterances (40-128 units) in
    chunks of 8: the manifest
    equal to a sequential in-process ddim_sample over the same chunks with
    the same noise, and the walls. Returns the CLI's launches."""
    import numpy as np

    from diffnorm_tpu_torch.cli import diff_norm_synthesis
    from diffnorm_tpu_torch.data.batching import bucket_length
    from diffnorm_tpu_torch.data.manifest import (
        read_translation_manifest,
        write_translation_manifest,
    )
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.ops.unit_reduce import reduce_units
    from diffnorm_tpu_torch.weights import save_npz, to_jax_params

    lines = LogLines()
    logging.getLogger("diffnorm_tpu_torch.diff_norm").addHandler(lines)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.manual_seed(0)
        with torch.device("cuda"):
            model = LatentDiffusionModule(**CLI_NORMALIZER)
        save_npz(str(tmp / "params.npz"), to_jax_params(model))
        del model
        feat_dir = write_train_corpus(tmp)  # 24 + 4 + 4 utterances, all of them "all"
        rows, feat_lines = [], [str(feat_dir)]
        for split in ("train", "dev", "test"):
            rows += read_translation_manifest(str(tmp / f"{split}.tsv"))
            feat_lines += (feat_dir / f"{split}.manifest.tsv").read_text().splitlines()[1:]
        if len(rows) != DDIM_CLI_UTTS:
            fail(f"loader DDIM CLI: {len(rows)} utterances, expected {DDIM_CLI_UTTS}")
        write_translation_manifest(str(tmp / "all.tsv"), rows)
        (feat_dir / "all.manifest.tsv").write_text("\n".join(feat_lines) + "\n")
        args = [str(tmp), "--params-npz", str(tmp / "params.npz"), "--tgt-feat-dir",
                str(feat_dir), "--output-dir", str(tmp / "out"), "--splits", "all",
                "--batch-size", str(DDIM_CLI_BATCH), "--seed", "1",
                *normalizer_flags(CLI_NORMALIZER)]
        parsed = diff_norm_synthesis.parse_args(args)
        device = torch.device("cuda")
        model = diff_norm_synthesis.build_model(parsed, device)
        generator = torch.Generator(device=device).manual_seed(1)
        items = []
        for row in rows:
            dedup, _, keep = reduce_units(np.asarray(row["tgt_audio"].split(), np.int64))
            items.append((row, dedup, keep))
        items.sort(key=lambda it: len(it[1]))
        expected, sample_wall, warm = [], 0.0, True
        for start in range(0, len(items), DDIM_CLI_BATCH):
            chunk = items[start:start + DDIM_CLI_BATCH]
            max_len = bucket_length(max(len(c[1]) for c in chunk))
            feat = np.zeros((len(chunk), max_len, 768), np.float32)
            mask = np.zeros((len(chunk), max_len), bool)
            for j, (row, dedup, keep) in enumerate(chunk):
                feat[j, :len(dedup)] = np.load(feat_dir / f"{row['id']}.feat.npy")[keep]
                mask[j, :len(dedup)] = True
            enc, init = diff_norm_synthesis.draw_noise(generator, (len(chunk), max_len, 128),
                                                       device)
            feat_d, mask_d = torch.from_numpy(feat).cuda(), torch.from_numpy(mask).cuda()
            if warm:  # the process's first sampling call, on other noise
                ddim_sample(model, feat_d, mask_d, start_step=parsed.start_step,
                            stride=parsed.ddim_stride, enc_noise=torch.randn_like(enc),
                            init_noise=torch.randn_like(init), device=device)
                warm = False
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            units, _ = ddim_sample(model, feat_d, mask_d, start_step=parsed.start_step,
                                   stride=parsed.ddim_stride, enc_noise=enc, init_noise=init,
                                   device=device)
            units = units.cpu().numpy()
            sample_wall += time.perf_counter() - t1
            for j, (row, dedup, _) in enumerate(chunk):
                norm_units, _, _ = reduce_units(units[j, :len(dedup)])
                expected.append({**row, "tgt_audio": " ".join(map(str, norm_units)),
                                 "tgt_n_frames": str(len(norm_units))})
        del model
        lines.lines.clear()
        _build.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if diff_norm_synthesis.main(args) != 0:
            fail("cli.diff_norm_synthesis with the prefetch failed")
        cli_wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        split_line = [m for m in lines.lines if m.startswith("all: normalized")]
        got = read_translation_manifest(str(tmp / "out" / "all.tsv"))
    logging.getLogger("diffnorm_tpu_torch.diff_norm").removeHandler(lines)
    if got != expected:
        bad = sum(a != b for a, b in zip(got, expected))
        fail(f"cli.diff_norm_synthesis with the prefetch: {bad} of {len(expected)} rows differ "
             f"from the sequential in-process run")
    print(f"loader DDIM CLI: {cli_wall:.2f} s for cli.diff_norm_synthesis on "
          f"{DDIM_CLI_UTTS} utterances in chunks of {DDIM_CLI_BATCH} (depth {CLI_NORMALIZER}, "
          f"the model's load included); {split_line[0] if split_line else 'no split line'}; in-process "
          f"ddim_sample over the same chunks {sample_wall:.2f} s; rows equal row for row; "
          f"launches {launches}; {smi}")
    return launches


def gradient_vector(torch, model, params, batch, criterion):
    loss, _ = criterion(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return torch.cat([(torch.zeros_like(p) if g is None else g).float().reshape(-1)
                      for p, g in zip(params, grads)])


def run_int8_train(torch, smi):
    """Phase 22d: --quant-int8 training, the int8 module route: one
    released-width normalizer update (B64 x T128, bf16, 2 timed after a
    warm-up; its bf16 gradient against the float32 recompute of the same
    scale-only gradient) and one long-form NAR update (B2 x 8448). Returns
    the launches of the timed updates."""
    import copy

    import numpy as np

    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.models.layers import set_live_int8
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.ops.quant import quant_sites
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    totals = {}
    micros = train_batches(torch, 3, 82, "ddpm")
    torch.manual_seed(11)
    with torch.device("cuda"):
        master = LatentDiffusionModule(quant_int8=True, int8_route="module", dropout=0.0)
    n_sites = len(quant_sites(master))
    cfg = TrainerConfig(lr=1e-4, warmup_updates=10000, warmup_init_lr=1e-7,
                        adam_betas=(0.9, 0.98), clip_norm=2.0, dtype="bfloat16", seed=42)
    crit = DDPMDiscreteLoss()
    # the gradient check first, on the initial weights; the float model's
    # own bf16-against-float32 agreement beside it
    def agreement(model):
        params = [p for n, p in model.named_parameters() if not n.startswith("vae.")]
        work = copy.deepcopy(model).to(torch.bfloat16).train()
        set_live_int8(work, model)
        wparams = [p for n, p in work.named_parameters() if not n.startswith("vae.")]
        g16 = gradient_vector(torch, work, wparams, micros[0], crit)
        del work
        set_live_int8(model)
        g32 = gradient_vector(torch, model.train(), params, micros[0], crit)
        finite = bool(torch.isfinite(g16).all() and torch.isfinite(g32).all())
        return (float(torch.dot(g16, g32) / (g16.norm() * g32.norm())),
                float((g16 - g32).norm() / g32.norm()), finite)

    cos, rel, finite = agreement(master)
    torch.manual_seed(11)
    with torch.device("cuda"):
        float_model = LatentDiffusionModule(dropout=0.0)
    float_model.load_state_dict(master.state_dict())
    cos_float, rel_float, _ = agreement(float_model)
    del float_model
    if not finite or cos < INT8_TRAIN_GRAD_COS or rel > INT8_TRAIN_GRAD_REL:
        fail(f"int8 train normalizer: bf16 gradient against the float32 recompute: finite "
             f"{finite}, cos {cos:.5f} (bound {INT8_TRAIN_GRAD_COS}), rel {rel:.4f} "
             f"(bound {INT8_TRAIN_GRAD_REL})")
    trainer = Trainer(cfg, master, crit, ("vae",))
    trainer.train_step([micros[0]])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per = []
    for u in (1, 2):
        _build.launch_counts.clear()
        t1 = time.perf_counter()
        mets = trainer.train_step([micros[u]])
        per.append((mets, 1e3 * (time.perf_counter() - t1), dict(_build.launch_counts)))
        if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
            fail(f"int8 train normalizer: update {u} gave {mets}")
        for k, v in per[-1][2].items():
            totals[k] = totals.get(k, 0) + v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if per[-1][2] != {"wavenet_chain": VAE_CHAINS, "rms_norm_film": 24}:
        fail(f"int8 train normalizer: launches {per[-1][2]}: the denoiser's int8 module route "
             f"launches no wavenet_chain (the frozen VAE's {VAE_CHAINS} chains do) and its 12 "
             f"layers' 24 adaptive norms rms_norm_film")
    wall = statistics.median(ms for _, ms, _ in per) / 1e3
    busy, _ = profile_run(torch, lambda: trainer.train_step([micros[1]]), wall)
    print(f"int8 train normalizer: --quant-int8 ({n_sites} int8 sites, module route), "
          f"B{B}xT{T}, bf16 forward, float32 masters: ms per update "
          f"{[round(ms, 1) for _, ms, _ in per]}, losses {[round(m['loss'], 5) for m, _, _ in per]},"
          f" gnorms {[round(m['gnorm'], 4) for m, _, _ in per]}, launches per update "
          f"{per[-1][2]}, peak {peak_gb:.2f} GB, busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f}%'}; bf16 gradient against "
          f"the float32 recompute: cos {cos:.5f} (bound {INT8_TRAIN_GRAD_COS}), rel {rel:.4f} "
          f"(bound {INT8_TRAIN_GRAD_REL}); the float model's: cos {cos_float:.5f}, rel "
          f"{rel_float:.4f}; {smi}")
    del trainer, master

    rng = np.random.default_rng(91)
    long = nar_batch(rng, [LONG_FRAMES, LONG_FRAMES // 2], [600, 300])
    torch.manual_seed(12)
    with torch.device("cuda"):
        model = NARS2UTModule(quant_int8=True, attention_dropout=0.0)
    trainer = Trainer(TrainerConfig(**NAR_TRAIN), model, NARSpeechToUnitLoss(0.2))
    trainer.valid_step(long, torch.Generator(device="cuda").manual_seed(0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    t1 = time.perf_counter()
    mets = trainer.train_step([long])
    ms = 1e3 * (time.perf_counter() - t1)
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
        fail(f"int8 train NAR long form: {mets}")
    if launches.get("flash_attention", 0) != 6:
        fail(f"int8 train NAR long form: flash_attention launched "
             f"{launches.get('flash_attention', 0)} times, expected 6 (the decoder's encoder "
             f"attentions)")
    busy, _ = profile_run(torch, lambda: trainer.train_step([long]), ms / 1e3)
    print(f"int8 train NAR, long form: --quant-int8 ({len(quant_sites(model))} int8 sites), "
          f"B2 x {LONG_FRAMES} frames (S = 2112): update {ms:.1f} ms, loss {mets['loss']:.5f}, "
          f"gnorm {mets['gnorm']:.4f}, launches {launches}, peak {peak_gb:.2f} GB, busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f}%'}; {smi}")
    del trainer, model
    return totals


def run_int8_vocoder(torch, smi):
    """Phase 22e: the int8 vocoder (the released code-HiFi-GAN, bf16),
    dynamic and static, on S2ST's decode shape: codes [16, 384] in chunks
    of 4 (phase 5's canvas): the wall against the float vocoder's, the
    relative error against it under JAX's bounds; then cli.s2st
    --int8-vocoder static on 8 utterances."""
    import numpy as np

    from diffnorm_tpu_torch.cli import s2st as s2st_cli
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest
    from diffnorm_tpu_torch.generate.s2st import _chunked_vocoder
    from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    rng = np.random.default_rng(93)
    codes = torch.from_numpy(rng.integers(0, 1000, size=(S2ST_B, S2ST_KW["max_wav_units"]))).cuda()
    outs, walls = {}, {}
    for mode in ("off", "dynamic", "static"):
        torch.manual_seed(3)
        voc = CodeHiFiGANVocoder.from_config(VOCODER_CFG, device="cuda", dtype=torch.bfloat16,
                                             int8_vocoder=mode).module
        with torch.no_grad():
            _chunked_vocoder(voc, codes, S2ST_KW["vocoder_chunk"])  # warm-up
            reps = []
            for _ in range(VOCODER_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                wav = _chunked_vocoder(voc, codes, S2ST_KW["vocoder_chunk"])
                torch.cuda.synchronize()
                reps.append(time.perf_counter() - t0)
        outs[mode], walls[mode] = wav.float(), statistics.median(reps)
        if mode == "static":
            n_blocks = len(voc.generator.int8_stats())
        del voc
    rels = {}
    for mode in ("dynamic", "static"):
        if not torch.isfinite(outs[mode]).all():
            fail(f"int8 vocoder {mode}: non-finite waveform")
        rels[mode] = float((outs[mode] - outs["off"]).norm() / outs["off"].norm())
        if rels[mode] >= INT8_VOCODER_REL[mode]:
            fail(f"int8 vocoder {mode}: relative error {rels[mode]:.4f} against the float "
                 f"vocoder (JAX's bound {INT8_VOCODER_REL[mode]})")
    print(f"int8 vocoder: codes [{S2ST_B}, {S2ST_KW['max_wav_units']}] in chunks of "
          f"{S2ST_KW['vocoder_chunk']}, bf16, median of {VOCODER_REPS}: float "
          f"{1e3 * walls['off']:.1f} ms, dynamic {1e3 * walls['dynamic']:.1f} ms "
          f"({walls['dynamic'] / walls['off']:.2f}x), static {1e3 * walls['static']:.1f} ms "
          f"({walls['static'] / walls['off']:.2f}x, {n_blocks} calibrated blocks); relative "
          f"error against the float vocoder: dynamic {rels['dynamic']:.4f} (bound "
          f"{INT8_VOCODER_REL['dynamic']}), static {rels['static']:.4f} (bound "
          f"{INT8_VOCODER_REL['static']}); {smi}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_npz(str(tmp / "nar.npz"), to_jax_variables(seeded_nar(torch, 0)))
        torch.manual_seed(3)
        voc = CodeHiFiGANVocoder.from_config(VOCODER_CFG, device="cuda")
        save_npz(str(tmp / "voc.npz"), to_jax_variables(voc.module))
        del voc
        (tmp / "voc.json").write_text(json.dumps(VOCODER_CFG))
        rows = []
        for i in range(8):
            n = int(rng.integers(300, 701))
            np.save(tmp / f"utt{i}.npy", rng.normal(size=(n, 80)).astype(np.float32))
            rows.append({"id": f"utt{i}", "src_audio": f"utt{i}.npy", "src_n_frames": n,
                         "tgt_audio": "0", "tgt_n_frames": 1})
        write_translation_manifest(str(tmp / "test.tsv"), rows)
        t0 = time.perf_counter()
        rc = s2st_cli.main([str(tmp), "--params-npz", str(tmp / "nar.npz"), "--vocoder-npz",
                            str(tmp / "voc.npz"), "--vocoder-cfg", str(tmp / "voc.json"),
                            "--results-path", str(tmp / "out"), "--batch-size", "4",
                            "--dur-prediction", "--max-duration", "4", "--int8-vocoder",
                            "static"])
        dt = time.perf_counter() - t0
        wavs = sorted(p.name for p in (tmp / "out").glob("*_pred.wav")) if rc == 0 else []
        if rc != 0 or len(wavs) != 8:
            fail(f"cli.s2st --int8-vocoder static: rc {rc}, {len(wavs)} waveforms")
    print(f"int8 vocoder cli.s2st --int8-vocoder static: {dt:.2f} s on 8 utterances (300-700 "
          f"frames, batch 4, the models' load and the calibration included), every "
          f"{{id}}_pred.wav written; {smi}")


def run_bridge(torch, smi):
    """Phase 22f: a normalizer step directory (released widths,
    CLI_NORMALIZER's depth) with a seeded Adam state in the bridge's format, written with numpy; cli.train
    --restore-file on it for 1 update (bf16) against an in-process Trainer
    loaded with the same state on the CLI's batch; the restore's wall.
    Returns the CLI's launches."""
    import importlib.util

    import numpy as np

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.tasks.diffusion_task import SpeechDiffusionDiscreteTask
    from diffnorm_tpu_torch.train.checkpoint import load_optax_state, load_variables
    from diffnorm_tpu_torch.train.trainer import Trainer
    from diffnorm_tpu_torch.weights import from_jax_variables, save_npz, to_jax_variables

    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", Path(__file__).resolve().parent / "scripts" / "orbax_to_npz.py")
    bridge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bridge)  # its numpy writer; JAX is imported only to restore
    step0 = 5
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        feat_dir = write_train_corpus(tmp)
        torch.manual_seed(21)
        with torch.device("cuda"):
            model = LatentDiffusionModule(**CLI_NORMALIZER)
        variables = to_jax_variables(model)
        del model
        step_dir = tmp / "bridged"
        step_dir.mkdir()
        t0 = time.perf_counter()
        save_npz(str(step_dir / "params.npz"), variables)
        rng = np.random.default_rng(22)
        trainable = {k: v for k, v in variables["params"].items() if k != "vae"}

        def moments(tree):
            """Adam's moments of gradients ~ N(0, 1e-3^2) seen step0 times:
            mu ~ 1e-3 N(0, 1), nu = mu^2 + 1e-6 (so |mu| / sqrt(nu) < 1)."""
            mu, nu = {}, {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    mu[k], nu[k] = moments(v)
                else:
                    mu[k] = (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                    nu[k] = (mu[k].astype(np.float64) ** 2 + 1e-6).astype(np.float32)
            return mu, nu

        mu, nu = moments(trainable)
        opt_state = [None, [{"count": np.int32(step0), "mu": mu, "nu": nu}, None,
                            {"count": np.int32(step0)}]]
        np.savez(step_dir / "optax_state.npz", **bridge.optax_arrays(opt_state, step0, None))
        (tmp / "bridged.json").write_text(json.dumps({"step": step0, "epoch": 1, "iterator": {
            "epoch": 1, "offset": 0, "seed": 42}}))
        write_wall = time.perf_counter() - t0
        del variables, opt_state, mu, nu
        args = [str(tmp), "--tgt-feat-dir", str(feat_dir), "--target-code-size", "1000",
                "--task", "speech_diffusion_discrete", "--criterion", "ddpm_discrete_loss",
                "--arch", "diff_discrete", "--latent-dim", "128", "--multitask", "true",
                "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt", "--warmup-init-lr", "1e-7",
                "--warmup-updates", "2", "--adam-betas", "(0.9,0.98)", "--clip-norm",
                "2.0", "--max-tokens", "1200", "--max-target-positions", "2048", "--seed",
                "42", "--log-interval", "1", "--dtype", "bfloat16", "--dropout", "0.1",
                "--max-update", str(step0 + 1), "--save-dir", str(tmp / "resumed"),
                "--restore-file", str(step_dir), *normalizer_flags(CLI_NORMALIZER)]
        seen = {}
        step = Trainer.train_step
        restore, load = train_cli.restore, Trainer.load_optax_state

        def capture(self, batches):
            seen["batches"] = [{k: v.clone() if torch.is_tensor(v) else v
                                for k, v in b.items()} for b in batches]
            seen["before"] = [p.detach().clone() for p in self.params]
            mets = step(self, batches)
            seen["after"] = [p.detach().clone() for p in self.params]
            return mets

        def timed_restore(*a, **kw):
            t1 = time.perf_counter()
            try:
                return restore(*a, **kw)
            finally:
                seen["restore_s"] = time.perf_counter() - t1

        def timed_load(self, bridged):
            t1 = time.perf_counter()
            try:
                return load(self, bridged)
            finally:
                seen["load_s"] = time.perf_counter() - t1

        Trainer.train_step, Trainer.load_optax_state = capture, timed_load
        train_cli.restore = timed_restore
        try:
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            rc = train_cli.main(args)
            cli_wall = time.perf_counter() - t0
            launches = dict(_build.launch_counts)
        finally:
            Trainer.train_step, Trainer.load_optax_state = step, load
            train_cli.restore = restore
        if rc != 0 or "after" not in seen:
            fail(f"cli.train --restore-file on the bridged step directory: rc {rc}")
        parsed = train_cli.parse_args(args)
        task = SpeechDiffusionDiscreteTask(parsed)
        with torch.device("cuda"):
            model = task.build_model()
        from_jax_variables(model, load_variables(str(step_dir)))
        trainer = Trainer(train_cli.trainer_config(parsed), model, task.build_criterion(),
                          frozen_keys=task.frozen_param_keys)
        trainer.load_optax_state(load_optax_state(str(step_dir)))
        if any(not torch.equal(a, b) for a, b in zip(trainer.params, seen["before"])):
            fail("bridge: the in-process trainer's weights differ from the CLI's before the update")
        trainer.train_step(seen["batches"])
        diff = max(float((p.detach() - a).abs().max())
                   for p, a in zip(trainer.params, seen["after"]))
        upd = max(float((a - b).abs().max()) for a, b in zip(seen["after"], seen["before"]))
        del trainer, model
    if diff > BRIDGE_UPDATE_REL * upd:
        fail(f"bridge: the CLI's update against the in-process Trainer's: {diff:.3e} against an "
             f"update of {upd:.3e} (bound {BRIDGE_UPDATE_REL} of it)")
    print(f"bridge: a normalizer step directory (released widths, depth {CLI_NORMALIZER}) "
          f"with a seeded Adam state (step {step0}) written by numpy in {write_wall:.2f} s; cli.train --restore-file, 1 "
          f"update in bf16: {cli_wall:.2f} s in all, restore {seen['restore_s']:.2f} s, optimizer "
          f"state load {seen['load_s']:.2f} s; against an in-process Trainer with the same state "
          f"on the same batch: max difference {diff:.3e}, the update's largest change "
          f"{upd:.3e} (bound {BRIDGE_UPDATE_REL} of it); launches {launches}; {smi}")
    return launches


def run_recipe_options(torch, smi):
    """Phase 22: the recipe's last training options (see the module
    docstring). Returns the kernels' launches."""
    t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    run_loader_nar(torch, smi)
    run_loader_vocoder(torch, smi)
    add(run_loader_ddim(torch, smi))
    add(run_int8_train(torch, smi))
    run_int8_vocoder(torch, smi)
    add(run_bridge(torch, smi))
    print(f"phase recipe options: {time.perf_counter() - t0:.1f} s, launches {launches}; {smi}")
    return launches


# the AR S2UT family (phase 23): fairseq's s2ut_conformer at its released
# widths (encoder 512 x 12, causal decoder 512 x 6, 8 heads, FFN 2048, vocab
# 1004), seeded, bf16, decoded as cli.generate does by default (beam 5,
# max_len 256): a random decoder seldom ranks EOS among the top candidates,
# so its decodes run to or near the 256 steps, the worst case. The cached
# decode against the full teacher-forced forward on the best hypotheses is
# one function in other GEMM shapes, bf16 rounding apart: its logits' rows
# are held to a cosine bound. In long form the decode through the kernel is
# held against the same decode through the plain versions: the encoder
# attention differs by sum order and a bf16 rounding, and a beam search parts
# at the first near-tie at the beam's boundary, after which its later units
# differ as well; so its units are held to a share (a broken kernel gives
# chance, ~0.001) and the teacher-forced logits on the kernel path's
# hypotheses, which follow no trajectory, to the row-cos bound. A decode's
# wall is one run after a warm-up cut to a few steps (the script's time
# limit); the teacher-forced forward's, a fraction of a second, the median
# of AR_FORWARD_REPS
AR_BEAM, AR_MAX_LEN, AR_FORWARD_REPS = 5, 256, 3
# a decode step's profile is the difference of two decodes cut to these
# lengths, which cancels the encode and keeps the profiled runs short (a
# whole decode launches ~90,000 kernels). Their walls are medians of more
# runs, as a difference doubles the host clock's spread
AR_PROFILE_LENS, AR_PROFILE_REPS = (8, 40), 3
AR_ROW_COS, AR_LONG_UNIT_AGREE = 0.999, 0.25
AR_FLASH_PER_STEP = 6  # the decoder's encoder attentions, one query a row
# the s2ut_transformer encoder's 12 self-attentions and the decoder's 6
# encoder attentions in a long-form teacher-forced forward
AR_TRANSFORMER_FLASH = 12 + 6
AR_RERANK_BEAM = 3
# the CLIs' AR decodes (phases 23d and 24e), each held to the same decode in
# process, cut to this many steps (--max-target-positions) and first-pass
# tokens (--max-len-b-mt): the full lengths run in phases 23a-b and 24a-c
CLI_MAX_LEN, CLI_MAX_LEN_MT = 64, 48


def seeded_ar(torch, seed: int, **kw):
    """The released s2ut_conformer (s2ut_transformer with
    encoder_type="transformer") from `seed`, bf16, eval mode."""
    from diffnorm_tpu_torch.models.ar_transformer import ARS2UTModule

    torch.manual_seed(seed)
    with torch.device("cuda"):
        model = ARS2UTModule(**kw)
    return model.to(torch.bfloat16).eval()


def shifted(torch, tokens):
    """prev_output_tokens of targets [B, L] on the card (the task's
    shift_right: EOS in front, PAD kept)."""
    from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right

    return torch.from_numpy(shift_right(tokens.cpu().numpy())).to(tokens.device)


def teacher_forced(torch, model, src, lengths, tokens):
    """Each row of `tokens` [B, L] (a decode's best hypotheses) through the
    model teacher-forced: (the full forward's logits, the cached decode's),
    float32 [n, V] at the positions before each row's first PAD."""
    with torch.no_grad():
        prev = shifted(torch, tokens)
        full = model(src, lengths, prev)["logits"]
        enc, mask = model.encode(src, lengths)
        cache = model.init_cache(enc, mask, prev.shape[1])
        pos = torch.zeros(prev.shape[0], dtype=torch.int64, device=prev.device)
        steps = [model.decode_step(prev[:, t:t + 1], cache, pos + t)[0]
                 for t in range(prev.shape[1])]
    real = torch.cumprod((prev != 1).long(), dim=1).bool()
    return full[real].float(), torch.stack(steps, dim=1)[real].float()


def min_row_cos(torch, a, b) -> float:
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def beam_steps(seqs) -> int:
    """The steps a beam search ran: its last finalized hypothesis's EOS
    position + 1."""
    return int((seqs == 2).int().argmax(dim=-1).max().item()) + 1


def run_ar_decode(torch, mods, smi):
    """Phase 23a-b: the beam decode at CVSS length and in long form (see the
    module docstring). Returns the flash_attention launches of the long-form
    decode's counted run."""
    from diffnorm_tpu_torch.generate.beam_search import ar_generate
    from diffnorm_tpu_torch.ops import _build

    ar = seeded_ar(torch, 23)
    launches = 0
    for what, b, frames in (("CVSS length", S2ST_B, S2ST_FRAMES),
                            ("long form", LONG_B, LONG_FRAMES)):
        src, lengths = s2st_inputs(torch, b, frames)

        def decode(n=AR_MAX_LEN):
            return ar_generate(ar, src, lengths, beam_size=AR_BEAM, max_len=n)

        def warm():  # the same kernels and shapes, a few steps
            return decode(AR_PROFILE_LENS[0])

        (seqs, scores), counts, wall = timed_decode(torch, decode, reps=1, warm=warm)
        steps = beam_steps(seqs)
        flash = counts.get("flash_attention", 0)
        long_form = frames == LONG_FRAMES
        want = AR_FLASH_PER_STEP * steps if long_form else 0
        if flash != want:
            fail(f"AR decode {what}: flash_attention launched {flash} times in {steps} steps, "
                 f"expected {want}")
        if seqs.shape != (b, AR_BEAM, AR_MAX_LEN) or not torch.isfinite(scores).all():
            fail(f"AR decode {what}: seqs {tuple(seqs.shape)}, scores {scores}")
        profiled = []  # (steps, wall, busy share, device kernels) of each short decode
        for n in AR_PROFILE_LENS:
            def short(n=n):
                return ar_generate(ar, src, lengths, beam_size=AR_BEAM, max_len=n)

            (short_seqs, _), _, short_wall = timed_decode(torch, short, reps=AR_PROFILE_REPS)
            profiled.append((beam_steps(short_seqs), short_wall)
                            + profile_run(torch, short, short_wall))
        full, stepped = teacher_forced(torch, ar, src, lengths, seqs[:, 0])
        cos = min_row_cos(torch, full, stepped)
        if cos < AR_ROW_COS:
            fail(f"AR decode {what}: the cached decode against the full forward, row-cos "
                 f"{cos:.6f} < {AR_ROW_COS}")
        audio_s = lengths.sum().item() * SECONDS_PER_FRAME
        (n0, wall0, busy0, kern0), (n1, wall1, busy1, kern1) = profiled
        if busy0 is None or busy1 is None or n1 <= n0:
            per_step = "a decode step's profile not measured"
        else:  # the encode, equal in both, cancels
            dn = n1 - n0
            step_wall, step_kernels = (wall1 - wall0) / dn, (kern1 - kern0) / dn
            step_busy = (busy1 * wall1 - busy0 * wall0) / dn
            per_step = (f"a decode step alone, the {n1}-step decode's profile less the "
                        f"{n0}-step one's: {step_kernels:.1f} device kernels, wall "
                        f"{1e3 * step_wall:.3f} ms, device busy {1e3 * step_busy:.3f} ms = "
                        f"{100 * step_busy / step_wall:.1f}%, {1e6 * step_wall / step_kernels:.1f}"
                        f" us of wall a kernel")
        print(f"AR decode, {what}: B{b} x {frames} frames, beam {AR_BEAM}, max_len "
              f"{AR_MAX_LEN}, bf16: wall {wall:.4f} s (one run), RTF "
              f"{audio_s / wall:.2f}, {steps} steps, {1e3 * wall / steps:.3f} ms a step, "
              f"{per_step}, flash_attention {flash} ({flash / steps:.1f} a step); best "
              f"scores {[round(v, 4) for v in scores[:, 0].tolist()[:4]]}; the cached decode "
              f"against the full teacher-forced forward on the best hypotheses ({len(full)} "
              f"positions): row-cos min {cos:.6f} (bound {AR_ROW_COS}); {smi}")
        if not long_form:
            continue
        launches += flash
        with plain_versions(*mods):
            (seqs_p, _), _, wall_p = timed_decode(torch, decode, reps=1, warm=warm)
            full_p, stepped_p = teacher_forced(torch, ar, src, lengths, seqs[:, 0])
        agree = unit_agreement(seqs[:, 0], seqs_p[:, 0])
        parted = (seqs[:, 0] != seqs_p[:, 0]).int()
        first = [int(r.argmax()) if r.any() else AR_MAX_LEN for r in parted]
        cos_full, cos_step = min_row_cos(torch, full, full_p), min_row_cos(torch, stepped,
                                                                            stepped_p)
        print(f"AR decode, long form, through the plain versions: wall {wall_p:.4f} s; best "
              f"hypotheses' units equal {agree:.4f} (bound {AR_LONG_UNIT_AGREE}), first "
              f"parting step per row {first}; teacher-forced on the kernel path's hypotheses, "
              f"kernel against plain: full forward row-cos min {cos_full:.6f}, cached decode "
              f"row-cos min {cos_step:.6f} (bound {AR_ROW_COS}); {smi}")
        if agree < AR_LONG_UNIT_AGREE or min(cos_full, cos_step) < AR_ROW_COS:
            fail(f"AR decode long form against the plain versions: units {agree:.4f}, "
                 f"row-cos {cos_full:.6f} / {cos_step:.6f}")
    _build.launch_counts.clear()
    return launches


def run_ar_transformer(torch, mods, smi):
    """Phase 23c: s2ut_transformer's long-form teacher-forced forward, the
    encoder's self-attentions through the kernel in eval, against the plain
    versions. Returns the counted forward's flash_attention launches."""
    import numpy as np

    model = seeded_ar(torch, 24, encoder_type="transformer")
    src, lengths = s2st_inputs(torch, LONG_B, LONG_FRAMES)
    rng = np.random.default_rng(231)
    tokens = rng.integers(4, 1004, size=(LONG_B, AR_MAX_LEN))
    tokens[:, -1] = 2
    tokens[1, AR_MAX_LEN // 2:] = 1
    tokens[1, AR_MAX_LEN // 2 - 1] = 2
    prev = shifted(torch, torch.from_numpy(tokens).cuda())
    real = prev != 1

    def forward():
        with torch.no_grad():
            return model(src, lengths, prev)["logits"][real].float()

    def encode():
        with torch.no_grad():
            enc, mask = model.encode(src, lengths)
            return enc[mask].float()

    logits, counts, wall = timed_decode(torch, forward, reps=AR_FORWARD_REPS)
    flash = counts.get("flash_attention", 0)
    if flash != AR_TRANSFORMER_FLASH:
        fail(f"s2ut_transformer long form: flash_attention launched {flash} times, expected "
             f"{AR_TRANSFORMER_FLASH}")
    enc = encode()
    with plain_versions(*mods):
        enc_p, logits_p = encode(), forward()
    cos_enc, cos = min_row_cos(torch, enc, enc_p), min_row_cos(torch, logits, logits_p)
    if min(cos_enc, cos) < AR_ROW_COS or not torch.isfinite(logits).all():
        fail(f"s2ut_transformer long form against the plain versions: encoder row-cos "
             f"{cos_enc:.6f}, logits row-cos {cos:.6f}")
    print(f"s2ut_transformer long form: B{LONG_B} x {LONG_FRAMES} frames (S = 2112, the last "
          f"row half), teacher-forced on {int(real.sum())} tokens, bf16 eval: forward "
          f"{wall:.4f} s (median of {AR_FORWARD_REPS}), flash_attention {flash} (12 in the encoder, 6 "
          f"in the decoder); against the plain versions: encoder row-cos min "
          f"{cos_enc:.6f}, logits row-cos min {cos:.6f} (bound {AR_ROW_COS}); {smi}")
    return flash


def ar_batch(rng, tasks, src_lengths, tgt_units):
    """Phase 10's batch made an AR one (prev_output_tokens) with seeded
    letter targets for each transformer aux task in `tasks`."""
    import numpy as np

    from diffnorm_tpu_torch.data.batching import bucket_length
    from diffnorm_tpu_torch.data.multitask import collate_text_targets
    from diffnorm_tpu_torch.tasks.ar_s2ut_task import shift_right

    batch = nar_batch(rng, src_lengths, tgt_units)
    del batch["prev_target"]
    batch["prev_output_tokens"] = shift_right(batch["target"])
    batch["multitask"] = {}
    for name, tc in tasks.items():
        targets = [np.append(rng.integers(4, len(OPT_LETTERS) + 4, size=max(n // 2, 1)),
                             2).astype(np.int32) for n in tgt_units]
        entry = collate_text_targets(targets, with_prev=True,
                                     pad_to=bucket_length(max(len(t) for t in targets)))
        entry["loss_weight"] = np.float32(tc.get_loss_weight(0))
        batch["multitask"][name] = entry
    return batch


def run_ar_train(torch, smi):
    """Phase 23d, training: one AR update with label_smoothed_cross_entropy
    and one with speech_to_unit and the target_letter aux head (encoder layer
    8) at phase 10's --max-tokens 40000 batch: ms, peak memory, busy share."""
    import types

    import numpy as np

    from diffnorm_tpu_torch.criterions.ce_loss import LabelSmoothedCrossEntropy, SpeechToUnitLoss
    from diffnorm_tpu_torch.data.multitask import MultitaskConfig
    from diffnorm_tpu_torch.models.ar_transformer import ARS2UTModule
    from diffnorm_tpu_torch.tasks.multitask_mixin import MultitaskTaskMixin
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(232)
    with tempfile.TemporaryDirectory() as tmp:
        tasks = MultitaskConfig(str(write_options_data(Path(tmp), rng))).get_all_tasks()
    tasks = {"target_letter": tasks["target_letter"]}
    specs = MultitaskTaskMixin.aux_task_specs(types.SimpleNamespace(multitask_tasks=tasks))
    hi = NAR_MAX_TOKENS // NAR_B
    batches = [ar_batch(rng, tasks, np.sort(rng.integers(300, hi + 1, NAR_B))[::-1],
                        rng.integers(100, 251, NAR_B).tolist()) for _ in range(3)]
    for name, criterion, kw in (
            ("label_smoothed_cross_entropy", LabelSmoothedCrossEntropy(0.1), {}),
            ("speech_to_unit with target_letter", SpeechToUnitLoss(0.1, multitask=tasks),
             dict(multitask=specs))):
        torch.manual_seed(232)
        with torch.device("cuda"):
            model = ARS2UTModule(**kw)
        trainer = Trainer(TrainerConfig(**NAR_TRAIN), model, criterion)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for batch in batches[:2]:
            t1 = time.perf_counter()
            mets = trainer.train_step([batch])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
            losses.append(mets["loss"])
            if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
                fail(f"AR train {name}: {mets}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy, _ = profile_run(torch, lambda: trainer.train_step([batches[2]]), ms[1] / 1e3)
        aux = {k: round(v, 4) for k, v in mets.items() if k.startswith("multitask_")}
        print(f"AR train, {name}: released s2ut_conformer, B{NAR_B} x "
              f"{batches[0]['src_tokens'].shape[1]} padded frames, targets "
              f"{batches[0]['target'].shape[1]} padded, bf16 forward, float32 masters: ms per "
              f"update {[round(v, 1) for v in ms]} (the first a warm-up), peak {peak_gb:.2f} GB, "
              f"busy "
              + ("not measured" if busy is None else f"{100 * busy:.1f}%")
              + f"; losses {[round(v, 4) for v in losses]} {aux}; {smi}")
        del model, trainer


def ar_hyps(torch, root: Path, decode):
    """{id: H- units} of decode(src, lengths) -> tokens [B, L] over the
    batches cli.generate makes of the test split (--max-tokens
    EVAL_MAX_TOKENS)."""
    from diffnorm_tpu_torch.cli.generate import strip_special
    from diffnorm_tpu_torch.data.dictionary import Dictionary
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset

    tgt_dict = Dictionary.unit_dictionary(1000)
    ds = SpeechToUnitDataset.from_tsv(str(root), "test", tgt_dict=tgt_dict)
    hyps = {}
    with torch.no_grad():
        for batch in EpochBatchIterator(ds, EVAL_MAX_TOKENS, shuffle=False).next_epoch_itr():
            tokens = decode(torch.from_numpy(batch["src_tokens"]).cuda(),
                            torch.from_numpy(batch["src_lengths"]).cuda())
            for row, sid in zip(tokens.cpu().numpy(), batch["id"].tolist()):
                hyps[sid] = strip_special(row, tgt_dict)
    return hyps


def run_ar_cli(torch, smi):
    """Phase 23d, the CLIs: cli.train --task speech_to_speech_ar on phase 11's
    corpus (2 updates), then cli.generate on its step directory with beam 5,
    with --sampling and with --score-reference, on a seeded stacked model
    with --n-frames-per-step 2, and the NAR decode reranked by the AR model
    (--rerank-path): each one's H- units against an in-process decode."""
    from diffnorm_tpu_torch.cli import generate
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.generate.beam_search import ar_generate, ar_generate_stacked
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    cuda = torch.device("cuda", torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_nar_corpus(tmp)
        save_dir = tmp / "ar"
        walls = {}
        lines = LogLines()
        logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = train_cli.main([
            str(tmp), "--config-yaml", "config.yaml", "--task", "speech_to_speech_ar",
            "--target-code-size", "1000", "--criterion", "label_smoothed_cross_entropy",
            "--label-smoothing", "0.1", "--arch", "s2ut_conformer", "--dropout", "0.1",
            "--save-dir", str(save_dir), "--lr", "5e-4", "--lr-scheduler", "inverse_sqrt",
            "--warmup-init-lr", "1e-7", "--warmup-updates", "10000", "--clip-norm", "10.0",
            "--max-update", "2", "--max-tokens", "8000", "--max-target-positions", "1024",
            "--seed", "42", "--validate-interval", "5", "--save-interval", "5", "--dtype",
            "bfloat16", "--log-interval", "1"])
        walls["cli.train"] = time.perf_counter() - t0
        logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
        if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines.lines):
            fail(f"cli.train --task speech_to_speech_ar: rc {rc}, log {lines.lines[-3:]}")
        step = save_dir / "step_000000002"
        base = [str(tmp), "--task", "speech_to_speech_ar", "--gen-subset", "test",
                "--max-tokens", str(EVAL_MAX_TOKENS)]
        ar = generate.build_ar_model(generate.parse_args(base + ["--path", str(step)]),
                                     str(step), cuda, torch.bfloat16)
        stacked = seeded_ar(torch, 25, n_frames_per_step=2)
        save_npz(str(tmp / "ar_k2.npz"), to_jax_variables(stacked))
        nar = seeded_nar(torch, 0)
        save_npz(str(tmp / "nar.npz"), to_jax_variables(nar))
        sampler = torch.Generator(device=cuda).manual_seed(7)
        cut = ["--max-target-positions", str(CLI_MAX_LEN)]
        runs = (
            ("beam 5", ["--path", str(step), "--beam", str(AR_BEAM), *cut],
             lambda s, n: ar_generate(ar, s, n, beam_size=AR_BEAM,
                                      max_len=CLI_MAX_LEN)[0][:, 0]),
            ("--sampling", ["--path", str(step), "--sampling", "--seed", "7", *cut],
             lambda s, n: ar_generate(ar, s, n, beam_size=AR_BEAM, max_len=CLI_MAX_LEN,
                                      sampling=True, generator=sampler)[0][:, 0]),
            ("--score-reference", ["--path", str(step), "--score-reference"], None),
            ("--n-frames-per-step 2", ["--path", str(tmp / "ar_k2.npz"),
                                       "--n-frames-per-step", "2", *cut],
             lambda s, n: ar_generate_stacked(stacked, s, n, max_len=CLI_MAX_LEN)[1].reshape(
                 s.shape[0], -1)),
            ("NAR --rerank-path", ["--task", "speech_to_speech_fasttranslate", "--arch",
                                   "nar_s2ut_conformer", "--path", str(tmp / "nar.npz"),
                                   "--iter-decode-with-beam", str(AR_RERANK_BEAM),
                                   "--rerank-path", str(step)],
             lambda s, n: mask_predict_decode(nar, s, n, max_iter=EVAL_MAX_ITER, max_len=256,
                                              length_beam=AR_RERANK_BEAM, reranker=ar)[0]),
        )
        for i, (what, flags, in_process) in enumerate(runs):
            out = tmp / f"gen{i}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if generate.main(base + flags + ["--results-path", str(out)]) != 0:
                fail(f"cli.generate {what} failed")
            walls[f"cli.generate {what}"] = time.perf_counter() - t0
            got = read_hyps(out / "generate-test.txt")
            if in_process is None:  # --score-reference: the references, scored
                text = (out / "generate-test.txt").read_text().splitlines()
                refs = {int(x.split("\t")[0][2:]): x.split("\t")[1] for x in text
                        if x.startswith("T-")}
                scores = [float(x.split("\t")[1]) for x in text if x.startswith("H-")]
                if got != refs or len(got) != 4 or not all(-50 < v < 0 for v in scores):
                    fail(f"cli.generate --score-reference: hyps {got}, scores {scores}")
                continue
            want = ar_hyps(torch, tmp, in_process)
            if got != want or len(got) != 4 or not all(got.values()):
                fail(f"cli.generate {what}: H- units differ from the in-process decode "
                     f"({sum(got.get(k) == v for k, v in want.items())} of {len(want)} equal)")
        del ar, stacked, nar
    print(f"AR CLIs on phase 11's corpus (released widths, bf16, 4 test WAVs of 3-7 s, "
          f"decodes cut to {CLI_MAX_LEN} steps): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + " (one run each); every cli.generate run's H- units equal to its in-process "
            f"decode, --score-reference's hypotheses its references; {smi}")


def run_ar_s2ut(torch, mods, smi):
    """Phase 23: the AR S2UT family (see the module docstring). Returns the
    flash_attention launches."""
    t0 = time.perf_counter()
    launches = run_ar_decode(torch, mods, smi)
    launches += run_ar_transformer(torch, mods, smi)
    run_ar_train(torch, smi)
    run_ar_cli(torch, smi)
    print(f"phase AR S2UT: {time.perf_counter() - t0:.1f} s, flash_attention launches "
          f"{launches}; {smi}")
    return launches


# the two-pass S2ST families and the spectrogram decoders (phase 24), at
# their published widths, seeded, bf16 (no UnitY or Translatotron2
# checkpoint is in the repository): UnitY (unity_conformer: encoder 256 x 16,
# 4 heads, FFN 2048; decoders 256 wide, 8 heads, FFN 2048, the first pass 4
# layers over phase 19's 28 letters + 4 specials, the unit decoder 6 over
# vocab 1004, --synthesizer-encoder-layers 2), s2spect_conformer (the same
# encoder, the mel decoder 512 x 6, 4 heads, FFN 2048, 80 bins, prenet
# dropout 0.5) and Translatotron2 (s2spect2_conformer: that encoder and mel
# decoder, the first pass 4 x 512), decoded as cli.generate does by default:
# beam 5 in every beam pass, the first pass at --max-len-b-mt 200, units at
# max_len 256, the mel rollout's 256 steps. The first pass's encoder
# attention takes the kernel in long form (D = 32 UnitY, D = 128
# Translatotron2), 4 launches a step plus 4 for its teacher-forced handoff;
# the mel decoder's encoder attention in s2spect 6 a step (D = 128); the
# second passes attend at most 200 text positions and never reach it. A
# decode through the kernel is held against the same decode through the
# plain versions: first-pass and unit tokens to phase 23's share, the
# teacher-forced logits on the kernel path's hypotheses to phase 23's
# row-cos, mels over each row's valid frames and over all the rollout's
# frames (the same prenet draws: one generator seed; seeded weights fire
# EOS at once, so a row's valid frames are few) to a mean row-cos; a
# cached decode against the
# teacher-forced forward (the prenet's draws off, which the two forms draw
# in other shapes) to TP_ROW_COS
TP_BEAM, TP_MAX_LEN, TP_MAX_LEN_MT, TP_MAX_ITER = 5, 256, 200, 256
TP_REPS, TP_PROFILE_REPS = 1, 2
TP_ROW_COS = 0.9999
TP_MEL_MEAN_COS = 0.99  # stated in PERF.md before the phase's first chip run
TP_PRENET_SEED = 24
TP_SYNTH_LAYERS = 2
TP_FLASH_PER_MT_STEP, TP_FLASH_PER_MEL_STEP = 4, 6
# the CLI's frames against the same rollout in process: one computation on
# the same inputs and generator seed, so equal but for a last-place bf16
# difference should a library take another algorithm between the two runs
TP_CLI_ATOL = 1.6e-2


def tp_mt_spec():
    """The first pass's task: target_letter over phase 19's letters."""
    from diffnorm_tpu_torch.models.nar_transformer import AuxTaskSpec

    return AuxTaskSpec(name="target_letter", decoder_type="transformer",
                       vocab_size=len(OPT_LETTERS) + 4, dropout=0.0)


def tp_model(torch, family: str, seed: int, dtype=None):
    """The family's model at its published widths from `seed` on the card,
    in eval mode and `dtype` (default bf16)."""
    from diffnorm_tpu_torch.models.s2spect import S2SpecTModule
    from diffnorm_tpu_torch.models.s2spect2 import S2SpecT2Module
    from diffnorm_tpu_torch.models.unity import UnityS2UTModule

    torch.manual_seed(seed)
    with torch.device("cuda"):
        if family == "unity":
            model = UnityS2UTModule(mt_spec=tp_mt_spec(),
                                    synthesizer_encoder_layers=TP_SYNTH_LAYERS)
        elif family == "s2spect":
            model = S2SpecTModule(encoder_type="conformer", enc_dim=256, enc_ffn_dim=2048,
                                  enc_layers=16, enc_heads=4)
        else:
            model = S2SpecT2Module(mt_spec=tp_mt_spec())
    return model.to(dtype or torch.bfloat16).eval()


class StepCounter:
    """Counts the calls of a model's step methods (the steps a pass ran)."""

    def __init__(self, model, *names):
        self.counts = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(model, name)

            def wrapped(*args, _name=name, _fn=fn, **kw):
                self.counts[_name] += 1
                return _fn(*args, **kw)

            setattr(model, name, wrapped)

    def take(self):
        out = dict(self.counts)
        self.counts = dict.fromkeys(self.counts, 0)
        return out


def tp_generator(torch):
    return torch.Generator(device="cuda").manual_seed(TP_PRENET_SEED)


def tp_decoders(torch, family, model, counter, src, lengths):
    """decode(n_mt, n) of the family as cli.generate runs it, cut to n_mt
    first-pass and n second-pass steps: (its outputs, {pass: steps})."""
    from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
    from diffnorm_tpu_torch.generate.translatotron2 import translatotron2_generate
    from diffnorm_tpu_torch.generate.unity import unity_generate

    def decode(n_mt=TP_MAX_LEN_MT, n=None):
        counter.take()
        if family == "unity":
            out = unity_generate(model, src, lengths, beam_size=TP_BEAM, beam_size_mt=TP_BEAM,
                                 max_len=n or TP_MAX_LEN, max_len_mt=n_mt)
        elif family == "s2spect":
            out = ar_speech_generate(model, src, lengths, max_iter=n or TP_MAX_ITER,
                                     generator=tp_generator(torch))
        else:
            out = translatotron2_generate(model, src, lengths, beam_size_mt=TP_BEAM,
                                          max_len_mt=n_mt, max_iter=n or TP_MAX_ITER,
                                          generator=tp_generator(torch))
        torch.cuda.synchronize()
        return out, counter.take()

    return decode


def tp_step_profile(torch, short, what):
    """A step alone of the pass that reaches the kernel (the first pass of a
    two-pass model, the mel rollout of s2spect): the profile of a decode
    whose pass is cut to AR_PROFILE_LENS[1] steps, less that of one cut to
    [0] (the encode and the other pass, cut to 2 steps, cancel)."""
    profiled = []
    for n in AR_PROFILE_LENS:
        (_, steps), _, wall = timed_decode(torch, lambda n=n: short(n), reps=TP_PROFILE_REPS)
        profiled.append((sum(steps.values()), wall)
                        + profile_run(torch, lambda n=n: short(n), wall))
    (n0, wall0, busy0, kern0), (n1, wall1, busy1, kern1) = profiled
    if busy0 is None or busy1 is None or n1 <= n0:
        return f"a {what} step's profile not measured"
    dn = n1 - n0
    step_wall, step_kernels = (wall1 - wall0) / dn, (kern1 - kern0) / dn
    step_busy = (busy1 * wall1 - busy0 * wall0) / dn
    return (f"a {what} step alone, the {n1}-step decode's profile less the {n0}-step one's: "
            f"{step_kernels:.1f} device kernels, wall {1e3 * step_wall:.3f} ms, device busy "
            f"{1e3 * step_busy:.3f} ms = {100 * step_busy / step_wall:.1f}%, "
            f"{1e6 * step_wall / step_kernels:.1f} us of wall a kernel")


def tp_first_pass_forced(torch, model, enc, mask, mt_best):
    """The first pass teacher-forced on mt_best [B, L]: (the full forward's
    logits, the cached steps'), float32 [n, Vmt] before each row's first
    PAD, and the handoff's context and mask."""
    from diffnorm_tpu_torch.generate.unity import handoff_tokens

    prev = handoff_tokens(mt_best)
    full = model.mt_decoder(prev, enc, mask)
    cache = model.init_mt_cache(enc, mask, prev.shape[1])
    pos = torch.zeros(prev.shape[0], dtype=torch.int64, device=prev.device)
    steps = torch.stack([model.decode_mt_step(prev[:, t:t + 1], cache, pos + t)[0]
                         for t in range(prev.shape[1])], dim=1)
    real = torch.cumprod((prev != 1).long(), dim=1).bool()
    ctx, ctx_mask = model.synthesize(model.mt_features(prev, enc, mask), prev != 1)
    return full[real].float(), steps[real].float(), ctx, ctx_mask


def tp_units_forced(torch, model, t2u, t2u_mask, units):
    """UnitY's unit pass teacher-forced on units [B, L] over t2u: (full,
    cached) float32 logits before each row's first PAD."""
    prev = shifted(torch, units)
    full = model.decoder(prev, t2u, t2u_mask)
    cache = model.init_cache(t2u, t2u_mask, prev.shape[1])
    pos = torch.zeros(prev.shape[0], dtype=torch.int64, device=prev.device)
    steps = torch.stack([model.decode_step(prev[:, t:t + 1], cache, pos + t)[0]
                         for t in range(prev.shape[1])], dim=1)
    real = torch.cumprod((prev != 1).long(), dim=1).bool()
    return full[real].float(), steps[real].float()


@contextlib.contextmanager
def prenet_off(model):
    saved, model.dec_prenet.p = model.dec_prenet.p, 0.0
    try:
        yield
    finally:
        model.dec_prenet.p = saved


def tp_mels_forced(torch, model, ctx, ctx_mask, n):
    """n cached mel steps over ctx from a zero frame, then decode_full
    teacher-forced on them, the prenet's draws off: (the full form's
    frames, the cached steps') float32 [B * n, out_dim]."""
    with prenet_off(model):
        cache = model.init_cache(ctx, ctx_mask, n)
        prev = torch.zeros(ctx.shape[0], 1, model.out_dim, dtype=ctx.dtype, device=ctx.device)
        steps = []
        for t in range(n):
            frame, _, cache = model.decode_step(prev, cache, t)
            steps.append(frame)
            prev = frame[:, None]
        steps = torch.stack(steps, dim=1)
        teacher = torch.cat([torch.zeros_like(steps[:, :1]), steps[:, :-1]], dim=1)
        ones = torch.ones(teacher.shape[:2], dtype=torch.bool, device=ctx.device)
        _, full, _ = model.decode_full(teacher, ones, ctx, ctx_mask)
    return full.reshape(-1, model.out_dim).float(), steps.reshape(-1, model.out_dim).float()


def mel_cos(torch, a, a_lens, b, b_lens):
    """Row-cos of two rollouts' frames [B, T, D] over each row's valid frames
    (the shorter length): (mean, min)."""
    rows = [torch.nn.functional.cosine_similarity(a[i, :n].float(), b[i, :n].float(), dim=-1)
            for i, n in enumerate(torch.minimum(a_lens, b_lens).tolist()) if n > 0]
    cos = torch.cat(rows)
    return cos.mean().item(), cos.min().item()


def run_two_pass_decode(torch, family, mods, smi):
    """Phase 24a-c, one family's decode at CVSS length and in long form (the
    module docstring). Returns the long form's counted flash_attention
    launches."""
    from diffnorm_tpu_torch.ops import _build

    model = tp_model(torch, family, {"unity": 241, "s2spect": 242, "t2": 243}[family])
    names = {"unity": ("decode_mt_step", "decode_step"), "s2spect": ("decode_step",),
             "t2": ("decode_mt_step", "decode_step")}[family]
    counter = StepCounter(model, *names)
    launches = 0
    for what, b, frames in (("CVSS length", S2ST_B, S2ST_FRAMES),
                            ("long form", LONG_B, LONG_FRAMES)):
        src, lengths = s2st_inputs(torch, b, frames)
        decode = tp_decoders(torch, family, model, counter, src, lengths)
        long_form = frames == LONG_FRAMES

        def warm():  # the same kernels and shapes, each pass cut to a few steps
            return decode(n_mt=AR_PROFILE_LENS[0], n=AR_PROFILE_LENS[0])

        (out, steps), counts, wall = timed_decode(torch, decode, reps=TP_REPS, warm=warm)
        flash = counts.get("flash_attention", 0)
        mt_steps = steps.get("decode_mt_step", 0)
        want = 0
        if long_form:
            want = (TP_FLASH_PER_MEL_STEP * steps["decode_step"] if family == "s2spect"
                    else TP_FLASH_PER_MT_STEP * (mt_steps + 1))
        if flash != want:
            fail(f"{family} decode {what}: flash_attention launched {flash} times in {steps}, "
                 f"expected {want}")
        per_step = "profiled in long form"
        if long_form:
            per_step = (tp_step_profile(torch, lambda n: decode(n_mt=n, n=2), "first-pass")
                        if family != "s2spect" else
                        tp_step_profile(torch, lambda n: decode(n=n), "mel"))
        with torch.no_grad():
            if family == "s2spect":
                enc, mask = model.encode(src, lengths)
                ctx, ctx_mask, cos_mt = enc, mask, None
            else:
                enc, mask = model.encode(src, lengths)
                mt_best = out[2] if family == "unity" else out[3]
                full_mt, step_mt, ctx, ctx_mask = tp_first_pass_forced(torch, model, enc, mask,
                                                                       mt_best)
                cos_mt = min_row_cos(torch, full_mt, step_mt)
            if family == "unity":
                full2, step2 = tp_units_forced(torch, model, ctx, ctx_mask, out[0][:, 0])
            else:
                full2, step2 = tp_mels_forced(torch, model, ctx, ctx_mask, 32)
            cos2 = min_row_cos(torch, full2, step2)
        if min(cos2, 1.0 if cos_mt is None else cos_mt) < TP_ROW_COS:
            fail(f"{family} decode {what}: the cached steps against the teacher-forced forward, "
                 f"row-cos {cos_mt} / {cos2:.6f} < {TP_ROW_COS}")
        if family == "unity":
            seqs, scores, mt_best = out
            ok = seqs.shape == (b, TP_BEAM, TP_MAX_LEN) and torch.isfinite(scores).all()
            result = (f"best scores {[round(v, 4) for v in scores[:, 0].tolist()[:4]]}, "
                      f"first-pass lengths {(mt_best != 1).sum(1).tolist()[:4]}")
        else:
            feat, out_lens = out[0], out[1]
            ok = (feat.shape == (b, TP_MAX_ITER, 80) and torch.isfinite(feat).all()
                  and bool((out_lens >= 1).all()))
            result = f"lengths {out_lens.tolist()[:4]}"
        if not ok:
            fail(f"{family} decode {what}: outputs {result}")
        audio_s = lengths.sum().item() * SECONDS_PER_FRAME
        print(f"{family} decode, {what}: B{b} x {frames} frames, bf16: wall {wall:.4f} s (one "
              f"run), RTF {audio_s / wall:.2f}, steps {steps}, {per_step}, flash_attention "
              f"{flash} (expected {want}); {result}; cached against teacher-forced, row-cos min "
              f"first pass {cos_mt}, second pass {cos2:.6f} (bound {TP_ROW_COS}); {smi}")
        if not long_form:
            continue
        launches += flash
        with plain_versions(*mods):
            (out_p, _), _, wall_p = timed_decode(torch, decode, reps=1, warm=warm)
            if family != "s2spect":
                with torch.no_grad():
                    enc_p, mask_p = model.encode(src, lengths)
                    full_p, step_p, _, _ = tp_first_pass_forced(torch, model, enc_p, mask_p,
                                                                 mt_best)
            else:
                with torch.no_grad():
                    full2_p, _ = tp_mels_forced(torch, model, enc, mask, 32)
        checks = []
        if family != "s2spect":
            mt_best_p = out_p[2] if family == "unity" else out_p[3]
            agree_mt = unit_agreement(mt_best, mt_best_p)
            cos_tf = min(min_row_cos(torch, full_mt, full_p), min_row_cos(torch, step_mt, step_p))
            checks.append((f"first-pass tokens equal {agree_mt:.4f}", agree_mt,
                           AR_LONG_UNIT_AGREE))
            checks.append((f"first pass teacher-forced on the kernel path's hypotheses, kernel "
                           f"against plain, row-cos min {cos_tf:.6f}", cos_tf, AR_ROW_COS))
        else:
            cos_tf = min_row_cos(torch, full2, full2_p)
            checks.append((f"mel decoder teacher-forced on the kernel path's frames, kernel "
                           f"against plain, row-cos min {cos_tf:.6f}", cos_tf, AR_ROW_COS))
        if family == "unity":
            agree = unit_agreement(out[0][:, 0], out_p[0][:, 0])
            checks.append((f"units equal {agree:.4f}", agree, AR_LONG_UNIT_AGREE))
        else:
            same = (slice(None) if family == "s2spect"
                    else (mt_best == mt_best_p).all(dim=1))
            n_rows = b if family == "s2spect" else int(same.sum())
            if n_rows:
                mean_cos, min_cos = mel_cos(torch, out[0][same], out[1][same],
                                            out_p[0][same], out_p[1][same])
                checks.append((f"mels over the valid frames of {n_rows} rows with equal "
                               f"first passes, row-cos mean {mean_cos:.6f} (min {min_cos:.6f}); "
                               f"lengths {out[1].tolist()} / {out_p[1].tolist()}", mean_cos,
                               TP_MEL_MEAN_COS))
                # the rollout runs all its steps whatever the lengths: every frame
                full_len = torch.full_like(out[1][same], TP_MAX_ITER)
                mean_all, min_all = mel_cos(torch, out[0][same], full_len, out_p[0][same],
                                            full_len)
                checks.append((f"mels over all {TP_MAX_ITER} rollout frames of those rows, "
                               f"row-cos mean {mean_all:.6f} (min {min_all:.6f})", mean_all,
                               TP_MEL_MEAN_COS))
        print(f"{family} decode, long form, through the plain versions: wall {wall_p:.4f} s; "
              + "; ".join(f"{text} (bound {bound_})" for text, _, bound_ in checks) + f"; {smi}")
        for text, value, bound_ in checks:
            if value < bound_:
                fail(f"{family} decode long form against the plain versions: {text} < {bound_}")
    _build.launch_counts.clear()
    del model
    return launches


def tp_batch(rng, tasks, src_lengths, tgt_frames):
    """Phase 10's sources with seeded 80-bin mel targets [B, bucket(T), 80]
    (prev_feats the shift behind a zero frame) and the letter targets of
    `tasks` (ar_batch's)."""
    import numpy as np

    from diffnorm_tpu_torch.data.batching import bucket_length

    batch = ar_batch(rng, tasks, src_lengths, [max(n // 4, 1) for n in tgt_frames])
    for key in ("target", "prev_output_tokens", "prev_target"):
        batch.pop(key, None)
    lens = np.asarray(tgt_frames, np.int32)
    t = bucket_length(int(lens.max()))
    mask = np.arange(t)[None, :] < lens[:, None]
    feat = (rng.normal(size=(len(lens), t, 80)) * mask[..., None]).astype(np.float32)
    prev = np.zeros_like(feat)
    prev[:, 1:] = feat[:, :-1]
    batch.update(feat_tgt=feat, prev_feats=prev, tgt_mask=mask, tgt_lengths=lens)
    return batch


def run_two_pass_train(torch, smi):
    """Phase 24d: one update of each family at phase 10's --max-tokens 40000
    batch (B64, 300-625 source frames; units 100-250; mels as long as the
    sources): ms, peak memory, busy share. Training forwards drop out, so
    the kernel is not reached (JAX keeps dropout off its kernel too)."""
    import numpy as np

    from diffnorm_tpu_torch.criterions.ce_loss import SpeechToUnit2PassLoss
    from diffnorm_tpu_torch.criterions.tts_loss import SpeechToSpectrogram2PassLoss, Tacotron2Loss
    from diffnorm_tpu_torch.data.multitask import MultitaskConfig
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(244)
    with tempfile.TemporaryDirectory() as tmp:
        tasks = MultitaskConfig(str(write_options_data(Path(tmp), rng))).get_all_tasks()
    tasks = {"target_letter": tasks["target_letter"]}
    hi = NAR_MAX_TOKENS // NAR_B
    for family, criterion in (
            ("unity", SpeechToUnit2PassLoss(0.1, multitask=tasks, mt_task_name="target_letter")),
            ("s2spect", Tacotron2Loss()),
            ("t2", SpeechToSpectrogram2PassLoss(multitask=tasks, mt_task_name="target_letter"))):
        batches = []
        for _ in range(3):
            src_lengths = np.sort(rng.integers(300, hi + 1, NAR_B))[::-1]
            if family == "unity":
                batches.append(ar_batch(rng, tasks, src_lengths,
                                        rng.integers(100, 251, NAR_B).tolist()))
            else:
                batches.append(tp_batch(rng, tasks if family == "t2" else {}, src_lengths,
                                        src_lengths.tolist()))
        model = tp_model(torch, family, 244, dtype=torch.float32).train()
        trainer = Trainer(TrainerConfig(**NAR_TRAIN), model, criterion)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for batch in batches[:2]:
            t1 = time.perf_counter()
            mets = trainer.train_step([batch])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
            losses.append(mets["loss"])
            if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
                fail(f"{family} train: {mets}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy, _ = profile_run(torch, lambda: trainer.train_step([batches[2]]), ms[1] / 1e3)
        aux = {k: round(v, 4) for k, v in mets.items() if k.startswith("multitask_")}
        print(f"{family} train: published widths, B{NAR_B} x "
              f"{batches[0]['src_tokens'].shape[1]} padded frames, bf16 forward, float32 "
              f"masters, {type(criterion).__name__}: ms per update "
              f"{[round(v, 1) for v in ms]} (the first a warm-up), peak {peak_gb:.2f} GB, busy "
              + ("not measured" if busy is None else f"{100 * busy:.1f}%")
              + f"; losses {[round(v, 4) for v in losses]} {aux}; {smi}")
        del model, trainer


def write_two_pass_corpus(root: Path, rng):
    """Phase 11's corpus (units) under `root` with a first-pass letter task
    (target_letter, flagged, beside phase 19's two other aux tasks), and
    under `root / "spect"` the same sources with seeded 80-bin mel targets
    as long as their fbank and the same aux tasks. Returns the spectrogram
    corpus's directory."""
    import numpy as np
    import yaml

    from diffnorm_tpu_torch.data.manifest import (
        read_translation_manifest,
        write_translation_manifest,
    )

    write_nar_corpus(root)
    units = {}
    for split in ("train", "dev", "test"):
        rows = read_translation_manifest(str(root / f"{split}.tsv"))
        units[split] = {r["id"]: int(r["tgt_n_frames"]) for r in rows}
        spect = root / "spect"
        (spect / "mel").mkdir(parents=True, exist_ok=True)
        out = []
        for r in rows:
            n = int(r["src_n_frames"])
            np.save(spect / "mel" / f"{r['id']}.npy", rng.normal(size=(n, 80)).astype(np.float32))
            out.append({**r, "src_audio": str(root / r["src_audio"]),
                        "tgt_audio": str(spect / "mel" / f"{r['id']}.npy"), "tgt_n_frames": n})
        write_translation_manifest(str(spect / f"{split}.tsv"), out)
    for d in (root, root / "spect"):
        path = write_options_data(d, rng, units)
        config = yaml.safe_load(path.read_text())
        config["target_letter"]["is_first_pass_decoder"] = True
        path.write_text(yaml.safe_dump(config))
    (root / "spect" / "config.yaml").write_text("{}\n")
    return root / "spect"


def run_two_pass_cli(torch, smi):
    """Phase 24e, the CLIs on phase 11's corpus (bf16, published widths):
    cli.train --task speech_to_speech --target-is-code --arch unity_conformer
    (speech_to_unit_2pass, 2 updates) then cli.generate with beam 5, whose H-
    units equal an in-process unity_generate of the step directory;
    cli.train --arch s2spect2_conformer (speech_to_spectrogram_2pass, 2
    updates) then cli.generate with a seeded mel-input vocoder, whose {id}.npy
    frames equal an in-process translatotron2_generate (its prenet draws
    from a generator seeded --seed), and cli.generate on a seeded
    s2spect_conformer .npz against ar_speech_generate likewise."""
    import numpy as np

    from diffnorm_tpu_torch.cli import generate
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli.train_vocoder import build_generator
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
    from diffnorm_tpu_torch.generate.translatotron2 import translatotron2_generate
    from diffnorm_tpu_torch.generate.unity import unity_generate
    from diffnorm_tpu_torch.tasks.s2spect_task import SpeechToSpectrogramDataset
    from diffnorm_tpu_torch.weights import save_npz, to_jax_variables

    cuda = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(245)
    walls = {}
    train_flags = ["--lr", "5e-4", "--lr-scheduler", "inverse_sqrt", "--warmup-init-lr", "1e-7",
                   "--warmup-updates", "10000", "--clip-norm", "10.0", "--max-update", "2",
                   "--max-tokens", "8000", "--max-target-positions", "1024", "--seed", "42",
                   "--validate-interval", "5", "--save-interval", "5", "--dtype", "bfloat16",
                   "--log-interval", "1", "--multitask-config-yaml", "multitask.yaml"]
    unity_flags = ["--task", "speech_to_speech", "--target-is-code", "--arch", "unity_conformer",
                   "--synthesizer-encoder-layers", str(TP_SYNTH_LAYERS),
                   "--multitask-config-yaml", "multitask.yaml"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        spect = write_two_pass_corpus(tmp, rng)
        for what, data, flags in (("unity", tmp, unity_flags),
                                  ("t2", spect, ["--task", "speech_to_speech", "--arch",
                                                 "s2spect2_conformer"])):
            lines = LogLines()
            logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = train_cli.main([str(data), *flags, "--save-dir", str(tmp / f"ck_{what}"),
                                 *train_flags])
            walls[f"cli.train {what}"] = time.perf_counter() - t0
            logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
            if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines.lines):
                fail(f"cli.train {what}: rc {rc}, log {lines.lines[-3:]}")
        # UnitY: cli.generate against the in-process decode
        step = tmp / "ck_unity" / "step_000000002"
        cut = ["--max-target-positions", str(CLI_MAX_LEN), "--max-len-b-mt",
               str(CLI_MAX_LEN_MT)]
        base = [str(tmp), *unity_flags, "--gen-subset", "test", "--max-tokens",
                str(EVAL_MAX_TOKENS), "--path", str(step), "--beam", str(TP_BEAM), *cut]
        t0 = time.perf_counter()
        if generate.main(base + ["--results-path", str(tmp / "gen_unity")]) != 0:
            fail("cli.generate unity failed")
        walls["cli.generate unity"] = time.perf_counter() - t0
        unity = generate.build_task_model(generate.parse_args(base), str(step), cuda,
                                          torch.bfloat16)[1]
        got = read_hyps(tmp / "gen_unity" / "generate-test.txt")
        want = ar_hyps(torch, tmp, lambda s, n: unity_generate(
            unity, s, n, beam_size=TP_BEAM, beam_size_mt=TP_BEAM, max_len=CLI_MAX_LEN,
            max_len_mt=CLI_MAX_LEN_MT)[0][:, 0])
        if got != want or len(got) != 4:
            fail(f"cli.generate unity: H- units differ from the in-process decode "
                 f"({sum(got.get(k) == v for k, v in want.items())} of {len(want)} equal)")
        del unity
        # the spectrogram branch: Translatotron2 trained, s2spect seeded
        vcfg = {**VOCODER_CFG, "model_in_dim": 80}
        torch.manual_seed(247)
        voc = build_generator(vcfg, input_type="features")
        save_npz(str(tmp / "voc.npz"), to_jax_variables(voc))
        (tmp / "voc.json").write_text(json.dumps(vcfg))
        hop = int(np.prod(VOCODER_CFG["upsample_rates"]))
        del voc
        s2spect = tp_model(torch, "s2spect", 246, dtype=torch.float32)
        save_npz(str(tmp / "s2spect.npz"), to_jax_variables(s2spect))
        del s2spect
        for what, arch, path, extra in (
                ("t2", "s2spect2_conformer", tmp / "ck_t2" / "step_000000002",
                 ["--vocoder", str(tmp / "voc.npz"), "--vocoder-cfg", str(tmp / "voc.json")]),
                ("s2spect", "s2spect_conformer", tmp / "s2spect.npz", [])):
            base = [str(spect), "--task", "speech_to_speech", "--arch", arch,
                    "--multitask-config-yaml", "multitask.yaml", "--gen-subset", "test",
                    "--max-tokens", str(EVAL_MAX_TOKENS), "--path", str(path), "--beam",
                    str(TP_BEAM), "--seed", "7", *cut]
            out = tmp / f"gen_{what}"
            t0 = time.perf_counter()
            if generate.main(base + ["--results-path", str(out)] + extra) != 0:
                fail(f"cli.generate {what} failed")
            walls[f"cli.generate {what}"] = time.perf_counter() - t0
            model = generate.build_task_model(generate.parse_args(base), str(path), cuda,
                                              torch.bfloat16)[1]
            ds = SpeechToSpectrogramDataset.from_tsv(str(spect), "test", is_train=False)
            g = torch.Generator(device=cuda).manual_seed(7)
            n_files, max_err = 0, 0.0
            for batch in EpochBatchIterator(ds, EVAL_MAX_TOKENS, shuffle=False).next_epoch_itr():
                src = torch.from_numpy(batch["src_tokens"]).to(cuda)
                lens = torch.from_numpy(batch["src_lengths"]).to(cuda)
                if what == "t2":
                    feat, out_lens, _, _ = translatotron2_generate(
                        model, src, lens, beam_size_mt=TP_BEAM, max_len_mt=CLI_MAX_LEN_MT,
                        max_iter=CLI_MAX_LEN, generator=g)
                else:
                    feat, out_lens, _ = ar_speech_generate(model, src, lens,
                                                           max_iter=CLI_MAX_LEN, generator=g)
                for i, sid in enumerate(batch["id"].tolist()):
                    got = np.load(out / f"{sid}.npy")
                    want = feat[i, :int(out_lens[i])].float().cpu().numpy()
                    if got.shape != want.shape:
                        fail(f"cli.generate {what} {sid}.npy: {got.shape}, in process "
                             f"{want.shape}")
                    max_err = max(max_err, float(np.abs(got - want).max(initial=0.0)))
                    if what == "t2":
                        import wave

                        with wave.open(str(out / f"{sid}_pred.wav")) as w:
                            if w.getnframes() != got.shape[0] * hop:
                                fail(f"cli.generate t2 {sid}_pred.wav: {w.getnframes()} samples")
                    n_files += 1
            if n_files != 4 or max_err > TP_CLI_ATOL:
                fail(f"cli.generate {what}: {n_files} files, max abs difference to the "
                     f"in-process rollout {max_err:.3e} > {TP_CLI_ATOL}")
            walls[f"{what} frames' max abs difference"] = max_err
            del model
    print(f"two-pass and spectrogram CLIs on phase 11's corpus (published widths, bf16, 4 test "
          f"WAVs of 3-7 s, decodes cut to {CLI_MAX_LEN_MT} first-pass tokens and {CLI_MAX_LEN} "
          f"units or frames): " + ", ".join(f"{k} {v:.4g}" + ("" if "difference" in k else " s")
                                         for k, v in walls.items())
          + f" (one run each); UnitY's H- units equal to the in-process decode, every .npy "
            f"within {TP_CLI_ATOL} of its in-process rollout, the vocoder's WAVs {hop} samples "
            f"a frame; {smi}")


def run_two_pass(torch, mods, smi):
    """Phase 24: UnitY, s2spect_conformer and Translatotron2 (see the module
    docstring). Returns the flash_attention launches."""
    t0 = time.perf_counter()
    launches = sum(run_two_pass_decode(torch, family, mods, smi)
                   for family in ("unity", "s2spect", "t2"))
    run_two_pass_train(torch, smi)
    run_two_pass_cli(torch, smi)
    print(f"phase two-pass S2ST: {time.perf_counter() - t0:.1f} s, flash_attention launches "
          f"{launches}; {smi}")
    return launches


# text-input TTS and the S2T model (phase 25), at their published widths,
# seeded (no checkpoint of either is in the repository), bf16 unless stated:
# tts_transformer_base (encoder 512 x 6 over 3 convs, 4 heads, the mel
# decoder 512 x 6, 80 bins) and fastspeech2_base (256 wide, 4 + 4 layers, 2
# heads, the 2048-frame buffer) over B8 sentences of 90-160 tokens of a
# 70-phone inventory (LJSpeech-length utterances); s2t_transformer (512 x 12,
# decoder 6, 8 heads) and s2t_conformer (256 x 16; decoder 256 x 6, 8 heads)
# over MuST-C's 8000-unigram vocabulary at phase 23's shapes. The seeded
# duration head of FastSpeech2 would predict no frame, so its output weights
# are zeroed and its bias set to log(1 + FS2_DUR): each
# token takes FS2_DUR frames and the rows fill 1080-1920 of the 2048 frames.
# The FastSpeech2 decoder's 4 self-attentions take the kernel in every eval
# forward, [8, 2, 2048, 128] with the frame mask, in float32 (the model's
# default type; three tf32 passes) and bf16; s2t_transformer's 12 encoder
# self-attentions and the decoders' 6 encoder attentions a step in long form
# (D = 64; s2t_conformer's D = 32);
# the tts_transformer attends at most 160 tokens and 256 frames and never
# reaches it. Each path through the kernel is held to the same path through
# the plain versions: FastSpeech2's frames over the valid ones by row-cos
# (FS2_ROW_COS, stated in PERF.md before the phase's first chip run) and its
# validation losses (FS2_LOSS_REL), the S2T decode's tokens and teacher-forced
# logits to phase 23's bounds.
TTS_VOCAB = 4 + 70
TTS_TOKENS = (160, 150, 140, 130, 120, 110, 100, 90)  # a row's tokens, </s> included
TTS_MAX_ITER = 256
FS2_DUR, FS2_FRAMES, FS2_FLASH = 12, 2048, 4
FS2_FLASH_KEYS = [FS2_DUR * n for n in TTS_TOKENS]  # each row's valid frames
FS2_ROW_COS = {"float32": 0.99999, "bfloat16": 0.999}
FS2_LOSS_REL = {"float32": 1e-5, "bfloat16": 1e-3}
S2T_VOCAB = 4 + 8000
S2T_ENCODER_FLASH = 12
# the CLIs' corpora: FastSpeech2's generation from the trained weights with
# its duration head set to this many frames a token
CLI_FS2_DUR = 6


def tts_tokens(torch, lengths, seed):
    """Token rows [B, max(lengths)] on the card: phones 4.. TTS_VOCAB - 1, </s>
    last, PAD after."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = np.full((len(lengths), max(lengths)), 1, np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n - 1] = rng.integers(4, TTS_VOCAB, size=n - 1)
        toks[i, n - 1] = 2
    return torch.from_numpy(toks).cuda()


def set_durations(torch, model, frames_a_token: int):
    """FastSpeech2's duration head predicting `frames_a_token` for every
    token: its output weights 0, its bias log(1 + frames_a_token)."""
    with torch.no_grad():
        model.dur_predictor.proj.weight.zero_()
        model.dur_predictor.proj.bias.fill_(math.log(1 + frames_a_token))
    return model


def fs2_batch(rng, tokens):
    """A validation batch on `tokens` [B, S] (numpy): gold durations of
    6-13 frames a token (total under the buffer), normal pitches and
    energies, 80-bin targets as long as the durations."""
    import numpy as np

    valid = tokens != 1
    dur = np.where(valid, rng.integers(6, 14, size=tokens.shape), 0).astype(np.int32)
    lens = np.minimum(dur.sum(1), FS2_FRAMES).astype(np.int32)
    mask = np.arange(int(lens.max()))[None, :] < lens[:, None]
    return {"src_tokens": tokens, "src_lengths": valid.sum(1).astype(np.int32),
            "durations": dur, "pitches": rng.normal(size=tokens.shape).astype(np.float32),
            "energies": rng.normal(size=tokens.shape).astype(np.float32),
            "feat_tgt": (rng.normal(size=mask.shape + (80,)) * mask[..., None]).astype(
                np.float32),
            "tgt_lengths": lens, "ntokens": int(lens.sum()), "nsentences": len(tokens)}


def frames_cos(out, ref):
    """Row-cos of two generations' features over each row's valid frames
    (numpy): (mean, min)."""
    import numpy as np

    a = out["feature"][out["frame_mask"]].astype(np.float64)
    b = ref["feature"][out["frame_mask"]].astype(np.float64)
    cos = (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1),
                                       1e-30)
    return float(cos.mean()), float(cos.min())


def run_fastspeech2(torch, mods, smi):
    """Phase 25b: fastspeech2_base's generation (NonARSpeechGenerator on
    predicted variances) and validation (fastspeech2_loss on gold ones) in
    float32 and bf16, each through the kernel and through the plain
    versions. Returns the counted flash_attention launches by type."""
    import numpy as np

    from diffnorm_tpu_torch.criterions.tts_loss import FastSpeech2Loss
    from diffnorm_tpu_torch.models.fastspeech2 import FastSpeech2Module, NonARSpeechGenerator
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.manual_seed(251)
    with torch.device("cuda"):
        master = set_durations(torch, FastSpeech2Module(vocab_size=TTS_VOCAB), FS2_DUR).eval()
    tokens = tts_tokens(torch, TTS_TOKENS, 252)
    batch = fs2_batch(np.random.default_rng(253), tokens.cpu().numpy())
    want_frames = np.minimum(np.asarray(TTS_TOKENS) * FS2_DUR, FS2_FRAMES)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        model = master if dtype == "float32" else copy.deepcopy(master).to(torch.bfloat16)
        gen = NonARSpeechGenerator(model)
        out, counts, wall = timed_decode(torch, lambda: gen.generate(tokens), reps=3)
        flash = counts.get("flash_attention", 0)
        frames = out["frame_mask"].sum(1)
        if (flash != FS2_FLASH or out["feature"].shape != (len(TTS_TOKENS), FS2_FRAMES, 80)
                or not np.isfinite(out["feature"]).all() or not (frames == want_frames).all()):
            fail(f"fastspeech2 generation {dtype}: flash_attention {flash} (expected "
                 f"{FS2_FLASH}), frames a row {frames.tolist()} (expected "
                 f"{want_frames.tolist()}), shape {out['feature'].shape}")
        with plain_versions(*mods):
            out_p, _, wall_p = timed_decode(torch, lambda: gen.generate(tokens), reps=1)
        cos_mean, cos_min = frames_cos(out, out_p)
        # validation: the trainer's valid step on the float32 master, the
        # forward in `dtype` (its working copy), eval mode
        trainer = Trainer(TrainerConfig(dtype=dtype, seed=1), master, FastSpeech2Loss())
        g = torch.Generator(device="cuda")
        vals, counts_v, wall_v = timed_decode(
            torch, lambda: trainer.valid_step(batch, g.manual_seed(0)), reps=1)
        flash_v = counts_v.get("flash_attention", 0)
        with plain_versions(*mods):
            vals_p = trainer.valid_step(batch, g.manual_seed(0))
        keys = ("loss", "l1_loss", "dur_loss", "pitch_loss", "energy_loss")
        rel = max(abs(vals[k] - vals_p[k]) / max(abs(vals_p[k]), 1e-12) for k in keys)
        master.eval()
        launches[dtype] = flash + flash_v
        print(f"fastspeech2 {dtype}: B{len(TTS_TOKENS)} x {list(TTS_TOKENS)} tokens, the "
              f"duration head at {FS2_DUR} frames a token: generation wall {wall:.4f} s (median "
              f"of 3), plain versions {wall_p:.4f} s, flash_attention {flash} (expected "
              f"{FS2_FLASH}), valid frames a row {frames.tolist()} of {FS2_FRAMES}; frames "
              f"against the plain run over the valid ones row-cos mean {cos_mean:.7f} min "
              f"{cos_min:.7f} (bound {FS2_ROW_COS[dtype]}); validation (gold durations, "
              f"{batch['tgt_lengths'].tolist()} frames) wall {wall_v:.4f} s, flash_attention "
              f"{flash_v}, {', '.join(f'{k} {vals[k]:.5f}' for k in keys)}, against the plain "
              f"versions max rel {rel:.2e} (bound {FS2_LOSS_REL[dtype]}); {smi}")
        if (flash_v != FS2_FLASH or cos_min < FS2_ROW_COS[dtype] or rel > FS2_LOSS_REL[dtype]
                or not all(math.isfinite(vals[k]) for k in keys)):
            fail(f"fastspeech2 {dtype} against the plain versions: row-cos {cos_min:.7f}, "
                 f"validation rel {rel:.2e}, flash_attention {flash_v}")
        del trainer, gen, model
    return launches


def run_tts_rollout(torch, smi):
    """Phase 25a: the tts_transformer_base rollout (ar_speech_generate over
    the text encoder, 256 steps, the prenet's dropout from a seeded
    generator): wall, frames, no flash_attention launch, the cached steps
    against the teacher-forced decoder (row-cos)."""
    from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
    from diffnorm_tpu_torch.models.tts_transformer import TTSTransformerModule

    torch.manual_seed(254)
    with torch.device("cuda"):
        model = TTSTransformerModule(vocab_size=TTS_VOCAB)
    model = model.to(torch.bfloat16).eval()
    tokens = tts_tokens(torch, TTS_TOKENS, 255)

    def decode(n=TTS_MAX_ITER):
        return ar_speech_generate(model, tokens, max_iter=n, generator=tp_generator(torch))

    (feat, out_lens, _), counts, wall = timed_decode(torch, decode, reps=1,
                                                     warm=lambda: decode(AR_PROFILE_LENS[0]))
    flash = counts.get("flash_attention", 0)
    with torch.no_grad():
        enc, mask = model.encode(tokens)
        full, stepped = tp_mels_forced(torch, model, enc, mask, 32)
    cos = min_row_cos(torch, full, stepped)
    ok = (feat.shape == (len(TTS_TOKENS), TTS_MAX_ITER, 80) and bool(torch.isfinite(feat).all())
          and bool((out_lens >= 1).all()) and flash == 0 and cos >= TP_ROW_COS)
    print(f"tts_transformer rollout: B{len(TTS_TOKENS)} x {list(TTS_TOKENS)} tokens, "
          f"{TTS_MAX_ITER} steps, bf16: wall {wall:.4f} s (one run), "
          f"{1e3 * wall / TTS_MAX_ITER:.3f} ms a step, lengths {out_lens.tolist()}, "
          f"flash_attention {flash} (expected 0); cached steps against the teacher-forced "
          f"decoder (32 frames, prenet off) row-cos min {cos:.6f} (bound {TP_ROW_COS}); {smi}")
    if not ok:
        fail(f"tts_transformer rollout: shape {tuple(feat.shape)}, lengths {out_lens.tolist()}, "
             f"flash_attention {flash}, row-cos {cos:.6f}")
    del model


def run_s2t_decode(torch, mods, smi):
    """Phase 25c: the S2T beam decode (beam 5, max_len 256): s2t_transformer
    at B16 x 480 and B2 x 8448 (12 encoder self-attentions and 6 encoder
    attentions a step, D = 64, through the kernel in long form) and
    s2t_conformer in long form (its decoder's 6 encoder attentions a step
    at D = 32, the conformer's own attention inline), each long form held to
    the plain versions. Returns the long forms' counted flash_attention
    launches."""
    from diffnorm_tpu_torch.generate.beam_search import ar_generate
    from diffnorm_tpu_torch.models.s2t_transformer import S2TModule, s2t_conformer_arch

    conformer = {}
    s2t_conformer_arch(conformer)
    launches, models = 0, {}
    for arch, what, b, frames in (("s2t_transformer", "CVSS length", S2ST_B, S2ST_FRAMES),
                                  ("s2t_transformer", "long form", LONG_B, LONG_FRAMES),
                                  ("s2t_conformer", "long form", LONG_B, LONG_FRAMES)):
        if arch not in models:
            models.clear()
            widths = {} if arch == "s2t_transformer" else dict(
                encoder_type="conformer", encoder_dim=conformer["encoder_embed_dim"],
                encoder_ffn_dim=conformer["encoder_ffn_embed_dim"],
                encoder_layers=conformer["encoder_layers"],
                encoder_heads=conformer["encoder_attention_heads"],
                decoder_dim=conformer["decoder_embed_dim"],
                decoder_ffn_dim=conformer["decoder_ffn_embed_dim"],
                decoder_heads=conformer["decoder_attention_heads"])
            torch.manual_seed(256)
            with torch.device("cuda"):
                model = S2TModule(vocab_size=S2T_VOCAB, **widths)
            models[arch] = model = model.to(torch.bfloat16).eval()
        src, lengths = s2st_inputs(torch, b, frames)

        def decode(n=AR_MAX_LEN):
            return ar_generate(model, src, lengths, beam_size=AR_BEAM, max_len=n)

        def warm():
            return decode(AR_PROFILE_LENS[0])

        (seqs, scores), counts, wall = timed_decode(torch, decode, reps=1, warm=warm)
        steps = beam_steps(seqs)
        flash = counts.get("flash_attention", 0)
        long_form = frames == LONG_FRAMES
        want = AR_FLASH_PER_STEP * steps if long_form else 0
        if long_form and arch == "s2t_transformer":
            want += S2T_ENCODER_FLASH
        full, stepped = teacher_forced(torch, model, src, lengths, seqs[:, 0])
        cos = min_row_cos(torch, full, stepped)
        print(f"{arch} decode, {what}: B{b} x {frames} frames, beam {AR_BEAM}, vocab "
              f"{S2T_VOCAB}, bf16: wall {wall:.4f} s (one run), {steps} steps, "
              f"{1e3 * wall / steps:.3f} ms a step, flash_attention {flash} (expected {want}); "
              f"best scores {[round(v, 4) for v in scores[:, 0].tolist()[:4]]}; the cached "
              f"decode against the full teacher-forced forward row-cos min {cos:.6f} (bound "
              f"{AR_ROW_COS}); {smi}")
        if (flash != want or cos < AR_ROW_COS or seqs.shape != (b, AR_BEAM, AR_MAX_LEN)
                or not torch.isfinite(scores).all()):
            fail(f"{arch} decode {what}: flash_attention {flash} (expected {want}), "
                 f"row-cos {cos:.6f}, seqs {tuple(seqs.shape)}")
        if not long_form:
            continue
        launches += flash
        with plain_versions(*mods):
            (seqs_p, _), _, wall_p = timed_decode(torch, decode, reps=1, warm=warm)
            full_p, stepped_p = teacher_forced(torch, model, src, lengths, seqs[:, 0])
        agree = unit_agreement(seqs[:, 0], seqs_p[:, 0])
        cos_full = min_row_cos(torch, full, full_p)
        cos_step = min_row_cos(torch, stepped, stepped_p)
        print(f"{arch} decode, long form, through the plain versions: wall {wall_p:.4f} s; "
              f"best hypotheses' tokens equal {agree:.4f} (bound {AR_LONG_UNIT_AGREE}); "
              f"teacher-forced on the kernel path's hypotheses, kernel against plain: full "
              f"forward row-cos min {cos_full:.6f}, cached decode {cos_step:.6f} (bound "
              f"{AR_ROW_COS}); {smi}")
        if agree < AR_LONG_UNIT_AGREE or min(cos_full, cos_step) < AR_ROW_COS:
            fail(f"{arch} long form against the plain versions: tokens {agree:.4f}, "
                 f"row-cos {cos_full:.6f} / {cos_step:.6f}")
    del models, model
    return launches


def tts_train_batch(rng, lengths, fs2: bool):
    """A training batch of phone rows (`lengths` tokens, </s> included) with
    80-bin mel targets: the tts_transformer's teacher-forced inputs, or
    FastSpeech2's gold durations (3-9 frames a token), pitches and
    energies."""
    import numpy as np

    from diffnorm_tpu_torch.data.batching import bucket_length

    b, s = len(lengths), max(lengths)
    tokens = np.full((b, s), 1, np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n - 1] = rng.integers(4, TTS_VOCAB, size=n - 1)
        tokens[i, n - 1] = 2
    valid = tokens != 1
    dur = np.where(valid, rng.integers(3, 10, size=(b, s)), 0).astype(np.int32)
    lens = dur.sum(1).astype(np.int32)
    t = int(lens.max()) if fs2 else bucket_length(int(lens.max()))
    mask = np.arange(t)[None, :] < lens[:, None]
    feat = (rng.normal(size=(b, t, 80)) * mask[..., None]).astype(np.float32)
    batch = {"src_tokens": tokens, "src_lengths": valid.sum(1).astype(np.int32),
             "feat_tgt": feat, "tgt_lengths": lens, "ntokens": int(lens.sum()),
             "nsentences": b}
    if fs2:
        batch.update(durations=dur, pitches=rng.normal(size=(b, s)).astype(np.float32),
                     energies=rng.normal(size=(b, s)).astype(np.float32))
    else:
        prev = np.zeros_like(feat)
        prev[:, 1:] = feat[:, :-1]
        batch.update(prev_feats=prev, tgt_mask=mask)
    return batch


def run_tts_s2t_train(torch, smi):
    """Phase 25d: one update of each model (bf16 forward, float32 masters,
    scripts/s2ut_train.sh's optimizer): the tts_transformer and FastSpeech2
    on B32 rows of 60-150 phones (3-9 frames a phone), the S2T model at phase
    10's --max-tokens 40000 batch with 20-60 target tokens: ms, peak, busy.
    Training forwards drop out, so no kernel is reached."""
    import numpy as np

    from diffnorm_tpu_torch.criterions.ce_loss import LabelSmoothedCrossEntropy
    from diffnorm_tpu_torch.criterions.tts_loss import FastSpeech2Loss, Tacotron2Loss
    from diffnorm_tpu_torch.models.fastspeech2 import FastSpeech2Module
    from diffnorm_tpu_torch.models.s2t_transformer import S2TModule
    from diffnorm_tpu_torch.models.tts_transformer import TTSTransformerModule
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(257)
    hi = NAR_MAX_TOKENS // NAR_B
    for name in ("tts_transformer", "fastspeech2", "s2t_transformer"):
        batches = []
        for _ in range(3):
            if name == "s2t_transformer":
                src_lengths = np.sort(rng.integers(300, hi + 1, NAR_B))[::-1]
                batches.append(ar_batch(rng, {}, src_lengths,
                                        rng.integers(20, 61, NAR_B).tolist()))
            else:
                batches.append(tts_train_batch(rng, rng.integers(60, 151, 32).tolist(),
                                               fs2=name == "fastspeech2"))
        torch.manual_seed(257)
        with torch.device("cuda"):
            model, criterion = {
                "tts_transformer": lambda: (TTSTransformerModule(vocab_size=TTS_VOCAB),
                                            Tacotron2Loss()),
                "fastspeech2": lambda: (FastSpeech2Module(vocab_size=TTS_VOCAB),
                                        FastSpeech2Loss()),
                "s2t_transformer": lambda: (S2TModule(vocab_size=S2T_VOCAB),
                                            LabelSmoothedCrossEntropy(0.1))}[name]()
        trainer = Trainer(TrainerConfig(**NAR_TRAIN), model, criterion)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for batch in batches[:2]:
            t1 = time.perf_counter()
            mets = trainer.train_step([batch])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
            losses.append(mets["loss"])
            if not (math.isfinite(mets["loss"]) and math.isfinite(mets["gnorm"])):
                fail(f"{name} train: {mets}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy, _ = profile_run(torch, lambda: trainer.train_step([batches[2]]), ms[1] / 1e3)
        shape = (f"{batches[0]['src_tokens'].shape[1]} padded frames" if name == "s2t_transformer"
                 else f"{batches[0]['feat_tgt'].shape[1]} padded mel frames")
        print(f"{name} train: published widths, B{len(batches[0]['src_tokens'])} x {shape}, "
              f"bf16 forward, float32 masters, {type(criterion).__name__}: ms per update "
              f"{[round(v, 1) for v in ms]} (the first a warm-up), peak {peak_gb:.2f} GB, busy "
              + ("not measured" if busy is None else f"{100 * busy:.1f}%")
              + f"; losses {[round(v, 4) for v in losses]}; {smi}")
        del model, trainer


def write_tts_cli_corpus(root: Path, rng):
    """train (8), dev (4) and test (4) utterances of 30-70 phones
    (`dict.txt`), 80-bin mels of 3-9 frames a phone with their durations,
    per-phone pitch and energy; absolute paths, as the dataset reads them."""
    import numpy as np

    phones = [f"p{k}" for k in range(TTS_VOCAB - 4)]
    (root / "dict.txt").write_text("".join(f"{p} 1\n" for p in phones))
    cols = ("id", "audio", "n_frames", "tgt_text", "duration", "pitch", "energy")
    for split, n in (("train", 8), ("dev", 4), ("test", 4)):
        lines = ["\t".join(cols)]
        for i in range(n):
            uid = f"{split}{i}"
            text = rng.choice(phones, size=int(rng.integers(30, 71)))
            dur = rng.integers(3, 10, size=len(text) + 1)
            np.save(root / f"{uid}.npy", rng.normal(size=(int(dur.sum()), 80)).astype(np.float32))
            for key in ("pitch", "energy"):
                np.save(root / f"{uid}_{key}.npy",
                        rng.normal(size=(len(text) + 1,)).astype(np.float32))
            lines.append("\t".join([uid, str(root / f"{uid}.npy"), str(int(dur.sum())),
                                    " ".join(text), " ".join(map(str, dur)),
                                    str(root / f"{uid}_pitch.npy"),
                                    str(root / f"{uid}_energy.npy")]))
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def write_s2t_cli_corpus(root: Path, rng):
    """Phase 11's WAV corpus under `root`, and under `root / "s2t"` its S2T
    manifests (id, audio, n_frames, tgt_text) with 10-30 words of an
    8000-word `dict.txt` a row, phase 11's transforms. Returns the S2T
    directory."""
    from diffnorm_tpu_torch.data.manifest import read_translation_manifest
    from diffnorm_tpu_torch.data.s2t_dataset import write_s2t_manifest

    write_nar_corpus(root)
    s2t = root / "s2t"
    s2t.mkdir()
    words = [f"w{k}" for k in range(S2T_VOCAB - 4)]
    (s2t / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    (s2t / "config.yaml").write_text((root / "config.yaml").read_text()
                                     + "vocab_filename: dict.txt\n")
    for split in ("train", "dev", "test"):
        write_s2t_manifest(str(s2t / f"{split}.tsv"), [
            {"id": r["id"], "audio": str(root / r["src_audio"]), "n_frames": r["src_n_frames"],
             "tgt_text": " ".join(rng.choice(words, size=int(rng.integers(10, 31))))}
            for r in read_translation_manifest(str(root / f"{split}.tsv"))])
    return s2t


def cli_validate_against(torch, data, flags, step, keys):
    """cli.validate --dtype bfloat16 on `step` against the trainer's valid
    step in process over the dev split's one batch (the same order): the
    metrics, and the max relative difference of `keys`."""
    import numpy as np

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli import validate
    from diffnorm_tpu_torch.tasks import TASKS
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
    from diffnorm_tpu_torch.weights import from_jax_variables

    base = [str(data), "--valid-subset", "dev", "--max-tokens", "100000", "--dtype",
            "bfloat16", *flags]
    got = validate.validate(validate.parse_args(base + ["--path", str(step)]))
    args = train_cli.parse_args(base + ["--max-update", "1"])
    task = TASKS[args.task](args)
    torch.manual_seed(args.seed)
    with torch.device("cuda"):
        model = task.build_model()
    from_jax_variables(model, load_variables(str(step)))
    trainer = Trainer(TrainerConfig(dtype="bfloat16", seed=args.seed), model,
                      task.build_criterion())
    ds = task.dataset("dev")
    batch = task.prepare_batch(ds.collater([ds[int(i)] for i in ds.ordered_indices()]),
                               np.random.default_rng(args.seed))
    want = trainer.valid_step(batch, torch.Generator(device="cuda").manual_seed(0))
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in keys)
    if rel > VALID_REL or got["nsentences"] != 4:
        fail(f"cli.validate {flags[:4]}: {got} against in process {want}")
    del trainer, model
    return got, rel


def run_tts_s2t_cli(torch, smi):
    """Phase 25e, the CLIs at the published widths in bf16: cli.train (2
    updates) -> cli.validate -> cli.generate for the tts_transformer and
    FastSpeech2 on a seeded phone corpus and for s2t_transformer on phase 11's
    WAVs with text targets. cli.validate against the in-process valid step;
    the tts_transformer's `{id}.npy` (the rollout cut to CLI_MAX_LEN steps,
    --seed 7) against ar_speech_generate with a generator seeded 7;
    FastSpeech2's (its duration head set to CLI_FS2_DUR frames a token)
    against NonARSpeechGenerator; the S2T H- lines (beam 5, CLI_MAX_LEN
    steps) against ar_generate. Returns FastSpeech2's flash_attention
    launches in its cli.validate and cli.generate runs."""
    import numpy as np

    from diffnorm_tpu_torch.cli import generate
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli.generate import strip_special
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.generate.beam_search import ar_generate
    from diffnorm_tpu_torch.generate.speech_ar import ar_speech_generate
    from diffnorm_tpu_torch.models.fastspeech2 import NonARSpeechGenerator
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import save_npz

    cuda = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(258)
    walls, flash = {}, 0
    train_flags = ["--lr", "5e-4", "--lr-scheduler", "inverse_sqrt", "--warmup-init-lr", "1e-7",
                   "--warmup-updates", "4000", "--clip-norm", "5.0", "--max-update", "2",
                   "--seed", "42", "--validate-interval", "5", "--save-interval", "5",
                   "--dtype", "bfloat16", "--log-interval", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "tts").mkdir()
        write_tts_cli_corpus(tmp / "tts", rng)
        s2t = write_s2t_cli_corpus(tmp, rng)
        runs = (("tts_transformer", tmp / "tts", ["--task", "text_to_speech", "--arch",
                                                   "tts_transformer"], "3000"),
                ("fastspeech2", tmp / "tts", ["--task", "text_to_speech", "--arch",
                                               "fastspeech2"], "3000"),
                ("s2t_transformer", s2t, ["--task", "speech_to_text", "--arch",
                                          "s2t_transformer"], "8000"))
        for name, data, flags, max_tokens in runs:
            lines = LogLines()
            logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
            t0 = time.perf_counter()
            rc = train_cli.main([str(data), *flags, "--save-dir", str(tmp / f"ck_{name}"),
                                 "--max-tokens", max_tokens, *train_flags])
            walls[f"cli.train {name}"] = time.perf_counter() - t0
            logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
            if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines.lines):
                fail(f"cli.train {name}: rc {rc}, log {lines.lines[-3:]}")
            step = tmp / f"ck_{name}" / "step_000000002"
            keys = {"tts_transformer": ("loss", "l1_loss", "mse_loss", "eos_loss"),
                    "fastspeech2": ("loss", "l1_loss", "dur_loss", "pitch_loss",
                                    "energy_loss"),
                    "s2t_transformer": ("loss", "nll_loss", "acc")}[name]
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            _, rel = cli_validate_against(torch, data, flags, step, keys)
            walls[f"cli.validate {name} (and in process)"] = time.perf_counter() - t0
            walls[f"cli.validate {name} max rel"] = rel
            if name == "fastspeech2":
                # the CLI's forward and the in-process one: 4 launches each
                flash += _build.launch_counts.get("flash_attention", 0)
                variables = load_variables(str(step))
                proj = variables["params"]["dur_predictor"]["proj"]
                proj["kernel"] = np.zeros_like(proj["kernel"])
                proj["bias"] = np.full_like(proj["bias"], math.log(1 + CLI_FS2_DUR))
                save_npz(str(tmp / "fs2.npz"), variables)
                path = tmp / "fs2.npz"
            else:
                path = step
            base = [str(data), *flags, "--gen-subset", "test", "--max-tokens", max_tokens,
                    "--path", str(path), "--seed", "7"]
            if name != "fastspeech2":  # FastSpeech2's flag is its frame buffer's
                base += ["--max-target-positions", str(CLI_MAX_LEN)]
            if name == "s2t_transformer":
                base += ["--beam", str(AR_BEAM)]
            out = tmp / f"gen_{name}"
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            if generate.main(base + ["--results-path", str(out)]) != 0:
                fail(f"cli.generate {name} failed")
            walls[f"cli.generate {name}"] = time.perf_counter() - t0
            if name == "fastspeech2":
                flash += _build.launch_counts.get("flash_attention", 0)
            task, model = generate.build_task_model(generate.parse_args(base), str(path), cuda,
                                                    torch.bfloat16)
            ds = task.dataset("test")
            g = torch.Generator(device=cuda).manual_seed(7)
            max_err, n_rows = 0.0, 0
            with torch.no_grad():
                for batch in EpochBatchIterator(ds, int(max_tokens),
                                                shuffle=False).next_epoch_itr():
                    src = torch.from_numpy(batch["src_tokens"]).to(cuda)
                    lens = torch.from_numpy(batch["src_lengths"]).to(cuda)
                    if name == "s2t_transformer":
                        tokens = ar_generate(model, src, lens, beam_size=AR_BEAM,
                                             max_len=CLI_MAX_LEN)[0][:, 0].cpu().numpy()
                        got = read_hyps(out / "generate-test.txt")
                        for row, sid in zip(tokens, batch["id"].tolist()):
                            if got.get(sid) != strip_special(row, task.tgt_dict):
                                fail(f"cli.generate s2t_transformer H-{sid} differs from the "
                                     f"in-process decode")
                            n_rows += 1
                        continue
                    if name == "fastspeech2":
                        res = NonARSpeechGenerator(model).generate(src)
                        want = [f[m] for f, m in zip(res["feature"], res["frame_mask"])]
                    else:
                        feat, out_lens, _ = ar_speech_generate(model, src, lens,
                                                               max_iter=CLI_MAX_LEN,
                                                               generator=g)
                        want = [feat[i, :int(n)].float().cpu().numpy()
                                for i, n in enumerate(out_lens.tolist())]
                    for w, sid in zip(want, batch["id"].tolist()):
                        got = np.load(out / f"{sid}.npy")
                        if got.shape != w.shape or got.shape[0] == 0:
                            fail(f"cli.generate {name} {sid}.npy: {got.shape}, in process "
                                 f"{w.shape}")
                        max_err = max(max_err, float(np.abs(got - w).max()))
                        n_rows += 1
            if n_rows != 4 or max_err > TP_CLI_ATOL:
                fail(f"cli.generate {name}: {n_rows} rows, max abs difference to the in-process "
                     f"run {max_err:.3e} > {TP_CLI_ATOL}")
            if name != "s2t_transformer":
                walls[f"{name} frames' max abs difference"] = max_err
            del model
    print(f"TTS and S2T CLIs (published widths, bf16; the phone corpus of 8 + 4 + 4 "
          f"utterances, phase 11's WAVs with text targets; the rollout and the S2T decode cut "
          f"to {CLI_MAX_LEN} steps): "
          + ", ".join(f"{k} {v:.4g}" + ("" if "difference" in k or "rel" in k else " s")
                      for k, v in walls.items())
          + f" (one run each); the S2T H- lines equal to the in-process decode, every .npy "
            f"within {TP_CLI_ATOL} of its in-process run; fastspeech2's CLI runs "
            f"flash_attention {flash}; {smi}")
    return flash


def run_tts_s2t(torch, mods, smi):
    """Phase 25: text-input TTS and the S2T model (see the module
    docstring). Returns the flash_attention launches by JSON row."""
    t0 = time.perf_counter()
    run_tts_rollout(torch, smi)
    fs2 = run_fastspeech2(torch, mods, smi)
    s2t = run_s2t_decode(torch, mods, smi)
    run_tts_s2t_train(torch, smi)
    cli = run_tts_s2t_cli(torch, smi)
    launches = {"flash_attention": fs2["bfloat16"] + s2t + cli,
                "flash_attention_f32": fs2["float32"]}
    print(f"phase TTS and S2T: {time.perf_counter() - t0:.1f} s, flash_attention launches "
          f"{launches}; {smi}")
    return launches


# Phase 26: text machine translation at full width (module docstring). The
# AR transformer_wmt_en_de_big over separate 32768-token source and target
# tables (WMT'14 En-De's joined BPE size), the text CMLM (cmlm_transformer)
# and the Levenshtein transformer (levenshtein_transformer), seeded, bf16.
# Each decodes B64 newstest-length sentences (10-100 tokens, </s> in), which
# reach no kernel, and B2 x 2112 tokens with the second row half valid
# (phase 23's key lengths): the text encoder's 6 self-attentions and, per
# decode step or decoder pass, the decoder's 6 encoder attentions go through
# flash_attention; the long forms are held to the plain versions.
MT_VOCAB = 32768
MT_B, MT_SRC_LENS = 64, (10, 100)
MT_BEAM, MT_LENPEN, MT_MAX_LEN = 4, 0.6, 200  # fairseq's WMT recipe; its max_len_b 200
MT_LONG_LENS = (2112, 1056)
MT_FLASH_LAYERS = 6  # an encoder's self-attentions; a decoder step's or pass's encoder ones
CMLM_ITER, CMLM_LENGTH_BEAM = 10, 5  # the CMLM paper's mask-predict
LEV_ITER, NAT_MAX_LEN = 9, 256  # fairseq's NAT recipe; the canvases' width
# the decodes against their plain versions: tokens equal (the share expected
# and the hard bound, phase 23's), teacher-forced logits' row-cos; the
# cached AR steps against the full forward
MT_AGREE_EXPECTED, MT_AGREE_BOUND, MT_ROW_COS, MT_STEP_COS = 0.5, 0.25, 0.999, 0.9999
MT_TRAIN_B, MT_TRAIN_MAX = 40, 100  # --max-tokens 4096: 40 rows of at most 100 tokens
MT_CLI_LAYERS = 2  # the CLIs' depth, where checkpoints are written
MT_CLI_WORDS = 600


def mt_tokens(torch, lengths, seed):
    """Token rows [B, max(lengths)] on the card: words 4..MT_VOCAB - 1, </s>
    last, PAD after."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = np.full((len(lengths), max(lengths)), 1, np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n - 1] = rng.integers(4, MT_VOCAB, size=n - 1)
        toks[i, n - 1] = 2
    return torch.from_numpy(toks).cuda()


def mt_shapes(torch, seed):
    """{what: (src, lengths)}: B64 newstest lengths (longest first, as the
    batcher orders them) and the B2 long form."""
    import numpy as np

    short = sorted(np.random.default_rng(seed).integers(MT_SRC_LENS[0], MT_SRC_LENS[1] + 1,
                                                        MT_B).tolist(), reverse=True)
    out = {}
    for what, lengths in (("newstest length", short), ("long form", list(MT_LONG_LENS))):
        out[what] = (mt_tokens(torch, lengths, seed + len(out)),
                     torch.tensor(lengths, device="cuda"))
    return out


def mt_model(torch, kind: str, seed: int, vocab: int = MT_VOCAB):
    """The released model of `kind` (transformer_wmt_en_de_big, cmlm, lev)
    from `seed`, bf16, eval mode."""
    from diffnorm_tpu_torch.models.cmlm_text import TextCMLMModule
    from diffnorm_tpu_torch.models.levenshtein import LevenshteinModule
    from diffnorm_tpu_torch.models.transformer_text import (
        TextTransformerModule,
        transformer_wmt_en_de_big_arch,
    )

    torch.manual_seed(seed)
    with torch.device("cuda"):
        if kind == "transformer":
            w = {}
            transformer_wmt_en_de_big_arch(w)
            model = TextTransformerModule(
                vocab, vocab, encoder_dim=w["encoder_embed_dim"],
                encoder_ffn_dim=w["encoder_ffn_embed_dim"], encoder_layers=w["encoder_layers"],
                encoder_heads=w["encoder_attention_heads"], decoder_dim=w["decoder_embed_dim"],
                decoder_ffn_dim=w["decoder_ffn_embed_dim"], decoder_layers=w["decoder_layers"],
                decoder_heads=w["decoder_attention_heads"], dropout=w["dropout"])
        elif kind == "cmlm":
            model = TextCMLMModule(vocab, vocab)
        else:
            model = LevenshteinModule(vocab, vocab)
    return model.to(torch.bfloat16).eval()


@contextlib.contextmanager
def counted_passes(module):
    """[n]: the forward calls of `module` while the block runs."""
    count = [0]
    handle = module.register_forward_hook(lambda *_: count.__setitem__(0, count[0] + 1))
    try:
        yield count
    finally:
        handle.remove()


def rows_cos(torch, a, b, mask) -> float:
    """The least row-cos of a and b [..., V] over the positions of `mask`."""
    return min_row_cos(torch, a[mask].float(), b[mask].float())


def run_mt_ar(torch, mods, smi):
    """Phase 26a: transformer_wmt_en_de_big's beam decode (beam 4, lenpen
    0.6, MT_MAX_LEN steps) at both shapes; the cached steps against the
    full forward; the long form against the plain versions. Returns the
    counted long-form decode's flash_attention launches."""
    from diffnorm_tpu_torch.generate.beam_search import ar_generate

    model = mt_model(torch, "transformer", 261)
    n_params = sum(p.numel() for p in model.parameters())
    launches = 0
    for what, (src, lengths) in mt_shapes(torch, 262).items():
        def decode(n=MT_MAX_LEN):
            return ar_generate(model, src, lengths, beam_size=MT_BEAM, max_len=n,
                               len_penalty=MT_LENPEN)

        (seqs, scores), counts, wall = timed_decode(torch, decode, reps=1,
                                                    warm=lambda: decode(AR_PROFILE_LENS[0]))
        steps = beam_steps(seqs)
        flash = counts.get("flash_attention", 0)
        long_form = what == "long form"
        want = MT_FLASH_LAYERS * (1 + steps) if long_form else 0
        short_wall = timed_decode(torch, lambda: decode(AR_PROFILE_LENS[1]), reps=1)[2]
        busy, kernels = profile_run(torch, lambda: decode(AR_PROFILE_LENS[1]), short_wall)
        full, stepped = teacher_forced(torch, model, src, lengths, seqs[:, 0])
        cos = min_row_cos(torch, full, stepped)
        print(f"transformer_wmt_en_de_big decode, {what}: {n_params / 1e6:.1f} M parameters, "
              f"B{src.shape[0]} x {src.shape[1]} tokens ({lengths.sum().item()} valid), beam "
              f"{MT_BEAM}, lenpen {MT_LENPEN}, vocab {MT_VOCAB}, bf16: wall {wall:.4f} s (one "
              f"run), {steps} steps, {1e3 * wall / steps:.3f} ms a step, "
              f"{src.shape[0] * steps / wall:.1f} sentence-steps/s; a {AR_PROFILE_LENS[1]}-step "
              f"decode {short_wall:.4f} s, device busy "
              + ("not measured" if busy is None else f"{100 * busy:.1f}%, {kernels} kernels")
              + f"; flash_attention {flash} (expected {want}); best scores "
              f"{[round(v, 4) for v in scores[:, 0].tolist()[:4]]}; cached steps against the "
              f"full forward on the best hypotheses ({len(full)} positions) row-cos min "
              f"{cos:.6f} (bound {MT_STEP_COS}); {smi}")
        if (flash != want or cos < MT_STEP_COS or seqs.shape != (src.shape[0], MT_BEAM,
                                                                   MT_MAX_LEN)
                or not torch.isfinite(scores).all()):
            fail(f"transformer decode {what}: flash_attention {flash} (expected {want}), "
                 f"row-cos {cos:.6f}, seqs {tuple(seqs.shape)}")
        if not long_form:
            continue
        launches += flash
        with plain_versions(*mods):
            (seqs_p, _), _, wall_p = timed_decode(torch, decode, reps=1,
                                                  warm=lambda: decode(AR_PROFILE_LENS[0]))
            full_p, stepped_p = teacher_forced(torch, model, src, lengths, seqs[:, 0])
        agree = unit_agreement(seqs[:, 0], seqs_p[:, 0])
        cos_full = min_row_cos(torch, full, full_p)
        cos_step = min_row_cos(torch, stepped, stepped_p)
        print(f"transformer_wmt_en_de_big decode, long form, through the plain versions: wall "
              f"{wall_p:.4f} s; best hypotheses' tokens equal {agree:.4f} (expected >= "
              f"{MT_AGREE_EXPECTED}, bound {MT_AGREE_BOUND}); teacher-forced on the kernel "
              f"path's hypotheses, kernel against plain: full forward row-cos min "
              f"{cos_full:.6f}, cached decode {cos_step:.6f} (bound {MT_ROW_COS}); {smi}")
        if agree < MT_AGREE_BOUND or min(cos_full, cos_step) < MT_ROW_COS:
            fail(f"transformer long form against the plain versions: tokens {agree:.4f}, "
                 f"row-cos {cos_full:.6f} / {cos_step:.6f}")
    del model
    return launches


def nat_forced(torch, model, src, lengths, canvas, head=0):
    """The NAT decoder's logits (head `head` of a Levenshtein decoder's
    output) on `canvas` [B', T], the encoder states repeated to its rows."""
    with torch.no_grad():
        enc, mask = model.encode(src, lengths)
        rep = canvas.shape[0] // enc.shape[0]
        out = model.decode(canvas, enc.repeat_interleave(rep, dim=0),
                           mask.repeat_interleave(rep, dim=0))
    return out[head] if isinstance(out, tuple) else out


def run_mt_nat(torch, mods, smi):
    """Phase 26b-c: cmlm_transformer's mask-predict (CMLM_ITER iterations,
    length beam CMLM_LENGTH_BEAM, every fill run: a seeded model with a tied
    output refills each <unk> with <unk>, so its canvas would repeat at once
    and the adaptive exit end the decode after one pass; fairseq's
    --iter-decode-force-max-iter) and levenshtein_transformer's decode
    (LEV_ITER iterations, eos penalty 0) at both shapes on NAT_MAX_LEN-token
    canvases; the long forms against the plain versions (tokens, and the
    decoder's logits on the kernel path's output). Returns the counted
    long-form decodes' flash_attention launches."""
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.models.levenshtein import levenshtein_decode

    launches = 0
    for kind, name in (("cmlm", "cmlm_transformer"), ("lev", "levenshtein_transformer")):
        model = mt_model(torch, kind, 263 if kind == "cmlm" else 264)
        for what, (src, lengths) in mt_shapes(torch, 265).items():
            if kind == "cmlm":
                def decode(n=CMLM_ITER):
                    return mask_predict_decode(model, src, lengths, max_iter=n,
                                               max_len=NAT_MAX_LEN, adaptive=False,
                                               length_beam=CMLM_LENGTH_BEAM)[0]
            else:
                def decode(n=LEV_ITER):
                    return levenshtein_decode(model, src, lengths, max_iter=n,
                                              max_len=NAT_MAX_LEN)

            decode(1)  # the warm-up: one iteration
            with counted_passes(model.decoder) as passes:
                tokens, counts, wall = timed_decode(torch, decode, reps=1, warm=lambda: None)
            flash = counts.get("flash_attention", 0)
            long_form = what == "long form"
            filled = (tokens != 1).sum(dim=1)
            # the kernel's share in long form: the encoder's, then each pass's
            want = MT_FLASH_LAYERS * (1 + passes[0]) if long_form else 0
            print(f"{name} decode, {what}: B{src.shape[0]} x {src.shape[1]} tokens, "
                  + (f"{CMLM_ITER} iterations, length beam {CMLM_LENGTH_BEAM}" if kind == "cmlm"
                     else f"{LEV_ITER} iterations, eos penalty 0")
                  + f", canvas {NAT_MAX_LEN}, bf16: wall {wall:.4f} s (one run), "
                  f"{passes[0]} decoder passes, {1e3 * wall / passes[0]:.3f} ms a pass, "
                  f"flash_attention {flash} (expected {want}); tokens a row "
                  f"{filled.min().item()}-{filled.max().item()}; {smi}")
            if flash != want or not bool((filled > 0).all()):
                fail(f"{name} decode {what}: flash_attention {flash}, filled {filled.tolist()}")
            if not long_form:
                continue
            launches += flash
            with plain_versions(*mods):
                tokens_p, _, wall_p = timed_decode(torch, decode, reps=1, warm=lambda: None)
                forced_p = nat_forced(torch, model, src, lengths, tokens)
            forced = nat_forced(torch, model, src, lengths, tokens)
            agree = unit_agreement(tokens, tokens_p)
            cos = rows_cos(torch, forced, forced_p, tokens != 1)
            print(f"{name} decode, long form, through the plain versions: wall {wall_p:.4f} s; "
                  f"tokens equal {agree:.4f} (expected >= {MT_AGREE_EXPECTED}, bound "
                  f"{MT_AGREE_BOUND}); the decoder's word logits on the kernel path's output, "
                  f"kernel against plain, row-cos min {cos:.6f} (bound {MT_ROW_COS}); {smi}")
            if agree < MT_AGREE_BOUND or cos < MT_ROW_COS:
                fail(f"{name} long form against the plain versions: tokens {agree:.4f}, "
                     f"row-cos {cos:.6f}")
        del model
    return launches


def mt_task(torch, tmp: Path, task: str, arch: str, *extra):
    """The port's task of --task `task` --arch `arch` on the unit
    dictionaries of MT_VOCAB symbols (no data files), bf16 forward."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.tasks import TASKS

    args = train_cli.parse_args([str(tmp), "--task", task, "--arch", arch, "--max-update", "2",
                                 "--src-vocab-size", str(MT_VOCAB), "--target-code-size",
                                 str(MT_VOCAB - 4), "--dtype", "bfloat16", "--warmup-updates",
                                 "4000", *extra])
    return args, TASKS[task](args)


def run_mt_train(torch, smi):
    """Phase 26d: one update of each model at --max-tokens 4096 (MT_TRAIN_B
    rows of at most MT_TRAIN_MAX tokens a side), the task's own batch
    preparation (the CMLM canvas, the Levenshtein canvases,
    prev_output_tokens): ms, peak memory, busy share, the losses finite."""
    import numpy as np

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(266)
    with tempfile.TemporaryDirectory() as tmp:
        for task_name, arch in (("translation", "transformer_wmt_en_de_big"),
                                ("cmlm_cg", "cmlm_transformer"),
                                ("translation_lev", "levenshtein_transformer")):
            args, task = mt_task(torch, Path(tmp), task_name, arch)
            batches = []
            for _ in range(3):
                src_lens = sorted(rng.integers(MT_SRC_LENS[0], MT_TRAIN_MAX + 1,
                                               MT_TRAIN_B).tolist(), reverse=True)
                tgt_lens = rng.integers(MT_SRC_LENS[0], MT_TRAIN_MAX + 1, MT_TRAIN_B).tolist()
                src = mt_tokens(torch, src_lens, int(rng.integers(1 << 30))).cpu().numpy()
                tgt = mt_tokens(torch, tgt_lens, int(rng.integers(1 << 30))).cpu().numpy()
                if task_name == "translation_lev":
                    tgt = np.concatenate([np.zeros((len(tgt), 1), tgt.dtype), tgt], axis=1)
                batch = {"src_tokens": src.astype(np.int32),
                         "src_lengths": np.asarray(src_lens, np.int32),
                         "target": tgt.astype(np.int32)}
                batches.append(task.prepare_batch(batch, rng))
            torch.manual_seed(267)
            with torch.device("cuda"):
                model = task.build_model()
            trainer = Trainer(train_cli.trainer_config(args), model, task.build_criterion())
            ms, peak_gb, mets = timed_updates(torch, trainer, batches[:2], arch)
            losses = [m["loss"] for m in mets]
            busy, _ = profile_run(torch, lambda: trainer.train_step([batches[2]]), ms[1] / 1e3)
            n_params = sum(p.numel() for p in trainer.params)
            tokens = int(sum((b["src_tokens"] != 1).sum() + (b["target"] != 1).sum()
                             for b in batches[:1]))
            print(f"{arch} update ({args.criterion}): {n_params / 1e6:.1f} M parameters, "
                  f"B{MT_TRAIN_B} x {batches[0]['src_tokens'].shape[1]} source and "
                  f"{batches[0]['target'].shape[1]} target tokens padded ({tokens} real), bf16 "
                  f"forward, float32 masters: ms per update {[round(v, 1) for v in ms]} (the "
                  f"first a warm-up), peak {peak_gb:.2f} GB, busy "
                  + ("not measured" if busy is None else f"{100 * busy:.1f}%")
                  + f"; losses {[round(v, 4) for v in losses]}; {smi}")
            del model, trainer


def write_mt_cli_corpus(root: Path, rng):
    """A seeded de-en bitext under `root`: 32 training, 8 valid and 8 test
    pairs of 10-40 words of MT_CLI_WORDS a side (every word in the training
    text)."""
    for lang in ("de", "en"):
        words = [f"{lang}{k}" for k in range(MT_CLI_WORDS)]
        for split, n in (("train", 32), ("valid", 8), ("test", 8)):
            lines = [" ".join(rng.choice(words, size=int(rng.integers(10, 41))))
                     for _ in range(n)]
            if split == "train":  # every word seen, so every test word has an entry
                lines += [" ".join(words[i:i + 40]) for i in range(0, MT_CLI_WORDS, 40)]
            (root / f"{split}.{lang}").write_text("\n".join(lines) + "\n")


def run_mt_cli(torch, smi):
    """Phase 26e, the CLIs (published widths, MT_CLI_LAYERS + MT_CLI_LAYERS
    layers, bf16) on a seeded bitext: cli.preprocess -> cli.train (2
    updates) -> cli.generate -> cli.interactive -> cli.score for each task;
    the H- lines of cli.generate and cli.interactive against the same
    decode in process, cli.score's BLEU against cli.generate's."""
    import numpy as np

    from diffnorm_tpu_torch.cli import generate, interactive, preprocess, score
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.generate.beam_search import ar_generate
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.models.levenshtein import levenshtein_decode

    cuda = torch.device("cuda", torch.cuda.current_device())
    walls = {}
    langs = ["--source-lang", "de", "--target-lang", "en"]
    decodes = {"translation": ["--beam", str(MT_BEAM), "--lenpen", str(MT_LENPEN)],
               "cmlm_cg": ["--iter-decode-max-iter", str(CMLM_ITER), "--iter-decode-with-beam",
                           str(CMLM_LENGTH_BEAM)],
               "translation_lev": ["--iter-decode-max-iter", str(LEV_ITER)]}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_mt_cli_corpus(tmp, np.random.default_rng(268))
        t0 = time.perf_counter()
        if preprocess.main(["--source-lang", "de", "--target-lang", "en", "--trainpref",
                            str(tmp / "train"), "--validpref", str(tmp / "valid"), "--testpref",
                            str(tmp / "test"), "--destdir", str(tmp / "bin")]) != 0:
            fail("cli.preprocess failed")
        walls["cli.preprocess"] = time.perf_counter() - t0
        data = str(tmp / "bin")
        for task_name, arch in (("translation", "transformer_wmt_en_de_big"),
                                ("cmlm_cg", "cmlm_transformer"),
                                ("translation_lev", "levenshtein_transformer")):
            model_flags = [data, "--task", task_name, "--arch", arch, *langs, "--encoder-layers",
                           str(MT_CLI_LAYERS), "--decoder-layers", str(MT_CLI_LAYERS)]
            lines = LogLines()
            logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
            t0 = time.perf_counter()
            rc = train_cli.main([*model_flags, "--save-dir", str(tmp / f"ck_{task_name}"),
                                 "--max-tokens", "4096", "--max-update", "2", "--lr", "5e-4",
                                 "--warmup-updates", "4000", "--dtype", "bfloat16",
                                 "--valid-subset", "valid", "--log-interval", "1"])
            walls[f"cli.train {arch}"] = time.perf_counter() - t0
            logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
            if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines.lines):
                fail(f"cli.train {task_name}: rc {rc}, log {lines.lines[-3:]}")
            step = str(tmp / f"ck_{task_name}" / "step_000000002")
            base = [*model_flags, "--path", step, "--max-target-positions", str(CLI_MAX_LEN)]
            out = tmp / f"gen_{task_name}"
            t0 = time.perf_counter()
            if generate.main(base + ["--gen-subset", "test", "--max-tokens", "4096",
                                     "--results-path", str(out), *decodes[task_name]]) != 0:
                fail(f"cli.generate {task_name} failed")
            walls[f"cli.generate {arch}"] = time.perf_counter() - t0
            args = generate.parse_args(base)
            task, model = generate.build_task_model(args, step, cuda, torch.bfloat16)

            def in_process(src, lens, length_beam=CMLM_LENGTH_BEAM):
                if task_name == "translation":
                    return ar_generate(model, src, lens, beam_size=MT_BEAM, max_len=CLI_MAX_LEN,
                                       len_penalty=MT_LENPEN)[0][:, 0]
                if task_name == "cmlm_cg":
                    return mask_predict_decode(model, src, lens, max_iter=CMLM_ITER,
                                               max_len=CLI_MAX_LEN,
                                               length_beam=length_beam)[0]
                return levenshtein_decode(model, src, lens, max_iter=LEV_ITER,
                                          max_len=CLI_MAX_LEN)

            got = read_hyps(out / "generate-test.txt")
            n_rows = 0
            with torch.no_grad():
                for b in EpochBatchIterator(task.dataset("test"), 4096,
                                            shuffle=False).next_epoch_itr():
                    tokens = in_process(torch.from_numpy(b["src_tokens"]).long().to(cuda),
                                        torch.from_numpy(b["src_lengths"]).to(cuda))
                    for row, sid in zip(tokens.cpu().numpy(), b["id"].tolist()):
                        if got.get(sid) != generate.strip_special(row, task.tgt_dict):
                            fail(f"cli.generate {task_name} H-{sid} differs from the "
                                 f"in-process decode")
                        n_rows += 1
            if n_rows != 8:
                fail(f"cli.generate {task_name}: {n_rows} rows")
            # cli.interactive on three test sources, one line each
            src_lines = (tmp / "test.de").read_text().splitlines()[:3]
            stdin, stdout = sys.stdin, sys.stdout
            sys.stdin, sys.stdout = io.StringIO("\n".join(src_lines) + "\n"), io.StringIO()
            t0 = time.perf_counter()
            try:
                rc = interactive.main(base + (decodes[task_name][:2] if task_name == "cmlm_cg"
                                              else decodes[task_name]))
            finally:
                printed = sys.stdout.getvalue()
                sys.stdin, sys.stdout = stdin, stdout
            walls[f"cli.interactive {arch}"] = time.perf_counter() - t0
            hyps = re.findall(r"^H-(\d+)\t(.*)$", printed, re.M)
            if rc != 0 or [int(i) for i, _ in hyps] != [0, 1, 2]:
                fail(f"cli.interactive {task_name}: rc {rc}, {printed[-300:]}")
            with torch.no_grad():
                for (_, hyp), line in zip(hyps, src_lines):
                    ids = torch.from_numpy(task.src_dict.encode_line(line)[None]).long().to(cuda)
                    row = in_process(ids, torch.tensor([ids.shape[1]], device=cuda),
                                     length_beam=1)[0].tolist()
                    if task_name == "translation_lev":
                        row = row[1:]  # the canvas's BOS
                    if hyp != " ".join(task.tgt_dict[t] for t in row if t not in (1, 2)):
                        fail(f"cli.interactive {task_name}: {hyp!r} differs from the in-process "
                             f"decode")
            # cli.score on cli.generate's D- and T- lines
            text = (out / "generate-test.txt").read_text()
            (tmp / "hyp.txt").write_text("\n".join(re.findall(r"^D-\d+\t\S+\t(.*)$", text, re.M))
                                         + "\n")
            (tmp / "ref.txt").write_text("\n".join(re.findall(r"^T-\d+\t(.*)$", text, re.M))
                                         + "\n")
            stdout, sys.stdout = sys.stdout, io.StringIO()
            try:
                rc = score.main(["--sys", str(tmp / "hyp.txt"), "--ref", str(tmp / "ref.txt")])
            finally:
                scored = sys.stdout.getvalue().strip()
                sys.stdout = stdout
            if rc != 0 or not text.rstrip().endswith(scored):
                fail(f"cli.score {task_name}: {scored!r} against cli.generate's "
                     f"{text.splitlines()[-1]!r}")
            walls[f"{arch} BLEU"] = scored
            del model
    print("text MT CLIs (published widths, " + f"{MT_CLI_LAYERS} + {MT_CLI_LAYERS} layers, bf16; "
          f"a seeded bitext of {MT_CLI_WORDS} words a side, 32 + 8 + 8 pairs): "
          + ", ".join(f"{k} {v:.4g} s" if isinstance(v, float) else f"{k}: {v}"
                      for k, v in walls.items())
          + f"; every H- line of cli.generate and cli.interactive equal to the in-process "
            f"decode, cli.score's BLEU equal to cli.generate's; {smi}")


def run_text_mt(torch, mods, smi):
    """Phase 26: text machine translation (see the module docstring).
    Returns the flash_attention launches of the counted long-form decodes."""
    t0 = time.perf_counter()
    launches = run_mt_ar(torch, mods, smi)
    launches += run_mt_nat(torch, mods, smi)
    run_mt_train(torch, smi)
    run_mt_cli(torch, smi)
    print(f"phase text MT: {time.perf_counter() - t0:.1f} s, flash_attention launches "
          f"{launches}; {smi}")
    return launches


# Phase 27: SEDD, the unit LM, IDDPM and MoE (module docstring). sedd_absorb
# and transformer_lm over the 1004-symbol unit dictionary (1000 units, the
# released unit vocabulary), seeded; SEDD's sampler at the --tokens-per-sample
# block (B16 x 1024) and in long form (B2 x 2112, the second row 1056 valid:
# 42 s of units at 50 Hz, past the 2048 keys where its self-attention goes
# through flash_attention).
SEDD_VOCAB = 1004
SEDD_STEPS, SEDD_REFINE_STEPS, SEDD_UNK_SHARE = 64, 16, 0.3
SEDD_SHAPES = {"block": [1024] * 16, "long form": [2112, 1056]}
SEDD_NORMS, SEDD_FLASH = 16, 8  # a score call's FiLM norms (2 x 8 layers), self-attentions
SEDD_ROW_COS = {"bfloat16": 0.999, "float32": 0.99999}
SEDD_TOKENS_EQUAL = 0.99  # one sampler update on shared uniforms, kernels against plain
SEDD_PROFILE_STEPS = 8
SEDD_TRAIN_B = 8
LM_B, LM_T = 16, 1024
# IDDPM over the Denoiser, kernels against the plain versions on the same
# noises. At the loop's first step (t = 960) the Denoiser magnifies
# rounding: an H100 put the kernels' and the plain versions' bf16 calls
# each 0.384 of the norm from the float32 call (0.9258 apart by row-cos),
# and the float32 samples 0.9984 apart by row-cos after 25 steps, the
# float32 calls 0.999999. So the bf16 sample is held by row-cos (25 steps
# of bf16 rounding: 0.991155), the bf16 call at t = 960 and the float32
# sample by their error against a reference (float32, float64), at most
# IDDPM_ERR_RATIO times the plain versions' error; the bf16 call at the
# last step (t = 0) and the float32 call at t = 960 by row-cos.
IDDPM_RESPACING, IDDPM_ROW_COS, IDDPM_ERR_RATIO = "ddim25", 0.99, {"call": 1.1, "sample": 1.25}
IDDPM_CALL_ROW_COS = {"bfloat16": 0.9995, "float32": 0.99999}
MOE_DIM, MOE_FFN, MOE_EXPERTS, MOE_TOKENS, MOE_AGREE = 512, 2048, 8, 16384, 0.99
LM_CLI_LAYERS = 2  # the CLIs' depth, where checkpoints are written
LM_CLI_UTTS = {"train": 64, "dev": 8, "test": 8}


def sedd_model(torch, seed, dtype):
    """sedd_absorb from `seed` on the card, in `dtype`, eval mode."""
    from diffnorm_tpu_torch.models.sedd import SEDDModule, sedd_absorb_arch

    w = {}
    sedd_absorb_arch(w)
    torch.manual_seed(seed)
    with torch.device("cuda"):
        model = SEDDModule(SEDD_VOCAB, dim=w["sedd_dim"], depth=w["sedd_depth"],
                           heads=w["sedd_heads"])
    return model.to(dtype).eval()


def sedd_mask(torch, lengths):
    return (torch.arange(max(lengths), device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None])


def run_sedd_decode(torch, mods, smi):
    """Phase 27a (module docstring). Returns the counted runs' launches by
    JSON row."""
    from diffnorm_tpu_torch.models import sedd
    from diffnorm_tpu_torch.ops import _build

    for lengths in SEDD_SHAPES.values():  # the FiLM norms' shapes, bf16 and float32
        check_rms_norm_film(torch, mods[0], len(lengths), max(lengths), cold=True)
    launches = {"rms_norm_film": 0, "flash_attention": 0, "flash_attention_f32": 0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        model = sedd_model(torch, 274, dtype)
        n_params = sum(p.numel() for p in model.parameters())
        for what, lengths in SEDD_SHAPES.items():
            b, t = len(lengths), max(lengths)
            valid = sedd_mask(torch, lengths)
            long_form = what == "long form"
            per_call = {"rms_norm_film": SEDD_NORMS,
                        "flash_attention": SEDD_FLASH if long_form else 0}
            g = torch.Generator(device="cuda").manual_seed(275)
            tokens = torch.randint(4, SEDD_VOCAB, (b, t), generator=g, device="cuda")
            x = torch.where(torch.rand(b, t, generator=g, device="cuda") < 0.5, model.mask_id,
                            tokens)
            sigma = torch.linspace(0.05, 3.0, b, device="cuda")
            # one score call through the kernels, counted, and through the
            # plain versions
            with torch.no_grad():
                _build.launch_counts.clear()
                got = model.log_score(x, sigma, valid)
                torch.cuda.synchronize()
                one = dict(_build.launch_counts)
                with plain_versions(*mods):
                    ref = model.log_score(x, sigma, valid)
            cos = rows_cos(torch, got, ref, valid)
            # one sampler update on shared uniforms (t = 0.5, dt of 64 steps)
            u = torch.rand(b, t, model.mask_id + 1, generator=g, device="cuda")
            tt = torch.full((b,), 0.5, device="cuda")
            dt = (1.0 - 1e-5) / SEDD_STEPS
            with torch.no_grad():
                step = sedd._update(model, x, tt, dt, valid, u, truncate=False)
                with plain_versions(*mods):
                    step_p = sedd._update(model, x, tt, dt, valid, u, truncate=False)
            equal = (step == step_p)[valid].float().mean().item()
            unmasked = ((step != model.mask_id) & (x == model.mask_id) & valid).sum().item()

            def sample(steps=SEDD_STEPS):
                gen = torch.Generator(device="cuda").manual_seed(276)
                return sedd.sedd_sample(model, b, t, steps=steps, valid_mask=valid,
                                        generator=gen)

            out, counts, wall = timed_decode(torch, sample, reps=1, warm=lambda: sample(2))
            want = {k: n * SEDD_STEPS for k, n in per_call.items()}
            got_counts = {k: counts.get(k, 0) for k in want}
            short_wall = timed_decode(torch, lambda: sample(SEDD_PROFILE_STEPS), reps=1)[2]
            busy, kernels = profile_run(torch, lambda: sample(SEDD_PROFILE_STEPS), short_wall)
            n_tokens = sum(lengths)
            print(f"sedd_absorb sample, {what}, {name}: {n_params / 1e6:.1f} M parameters, B{b} "
                  f"x {t} ({n_tokens} valid), {SEDD_STEPS} steps: wall {wall:.4f} s (one run), "
                  f"{1e3 * wall / SEDD_STEPS:.3f} ms a step, {n_tokens / wall:.1f} tokens/s; a "
                  f"{SEDD_PROFILE_STEPS}-step sample {short_wall:.4f} s, device busy "
                  + ("not measured" if busy is None else f"{100 * busy:.1f}%, {kernels} kernels")
                  + f"; launches {got_counts} (expected {want}); one score call {one}; its "
                  f"log-scores against the plain versions row-cos min {cos:.6f} (bound "
                  f"{SEDD_ROW_COS[name]}); one update on shared uniforms: tokens equal "
                  f"{equal:.5f} (bound {SEDD_TOKENS_EQUAL}), {unmasked} positions unmasked; "
                  f"{smi}")
            if (got_counts != want or {k: one.get(k, 0) for k in per_call} != per_call
                    or cos < SEDD_ROW_COS[name] or equal < SEDD_TOKENS_EQUAL
                    or out.shape != (b, t) or (out == model.mask_id).any()
                    or out.min() < 0):
                fail(f"sedd_absorb {what} {name}: launches {got_counts} / {one}, row-cos "
                     f"{cos:.6f}, tokens equal {equal:.5f}, MASK left "
                     f"{(out == model.mask_id).sum().item()}")
            flash_key = "flash_attention" if dtype == torch.bfloat16 else "flash_attention_f32"
            launches["rms_norm_film"] += got_counts["rms_norm_film"]
            launches[flash_key] += got_counts["flash_attention"]
            if not long_form:
                continue
            canvas = torch.where(torch.rand(b, t, generator=g, device="cuda") < SEDD_UNK_SHARE,
                                 sedd.UNK, tokens)
            canvas = torch.where(valid, canvas, 1)

            def refine():
                gen = torch.Generator(device="cuda").manual_seed(277)
                return sedd.sedd_refine(model, canvas, valid, steps=SEDD_REFINE_STEPS,
                                        generator=gen)

            fixed, counts, wall = timed_decode(torch, refine, reps=1)
            want = {k: n * SEDD_REFINE_STEPS for k, n in per_call.items()}
            got_counts = {k: counts.get(k, 0) for k in want}
            masked = canvas == sedd.UNK
            kept = (fixed == canvas)[~masked].all().item()
            filled = (fixed != sedd.UNK)[masked & valid].float().mean().item()
            print(f"sedd_absorb refine, long form, {name}: {SEDD_REFINE_STEPS} steps on a canvas "
                  f"{masked[valid].float().mean().item():.3f} <unk>: wall {wall:.4f} s, launches "
                  f"{got_counts} (expected {want}); unmasked positions unchanged {kept}, "
                  f"masked positions filled {filled:.4f}; {smi}")
            if got_counts != want or not kept:
                fail(f"sedd_refine {name}: launches {got_counts}, unmasked kept {kept}")
            launches["rms_norm_film"] += got_counts["rms_norm_film"]
            launches[flash_key] += got_counts["flash_attention"]
        del model
    return launches


def lm_task(torch, tmp, task, *extra):
    """The port's task of --task `task` on the 1000-unit dictionary (no
    data files), bf16 forward."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.tasks import TASKS

    args = train_cli.parse_args([str(tmp), "--task", task, "--max-update", "2", "--dtype",
                                 "bfloat16", "--warmup-updates", "4000", *extra])
    return args, TASKS[task](args)


def unit_rows(b, t, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(4, SEDD_VOCAB, (b, t)).astype(np.int32)


def run_sedd_lm_train(torch, smi):
    """Phase 27b and c: one sedd_loss update at B8 x 1024 and
    transformer_lm's eval_lm NLL over B16 x 1024 blocks and one update."""
    import numpy as np

    from diffnorm_tpu_torch.cli import eval_lm
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        args, task = lm_task(torch, tmp, "sedd")
        torch.manual_seed(278)
        with torch.device("cuda"):
            model = task.build_model()
        trainer = Trainer(train_cli.trainer_config(args), model, task.build_criterion())
        batches = [{"target_unit": unit_rows(SEDD_TRAIN_B, 1024, 279 + i),
                    "target_lengths": np.full(SEDD_TRAIN_B, 1024, np.int32)} for i in range(2)]
        _build.launch_counts.clear()
        ms, peak, mets = timed_updates(torch, trainer, batches, "sedd_absorb")
        mets = mets[-1]
        counts = dict(_build.launch_counts)
        print(f"sedd_absorb update (sedd_loss): B{SEDD_TRAIN_B} x 1024, bf16 forward, float32 "
              f"masters: ms per update {[round(v, 1) for v in ms]} (the first a warm-up), peak "
              f"{peak:.2f} GB, loss {mets['loss']:.4f}, gnorm {mets['gnorm']:.4f}, launches "
              f"{counts}; {smi}")
        if counts.get("rms_norm_film", 0) != 2 * SEDD_NORMS:
            fail(f"sedd update launches {counts}")
        del model, trainer

        args, task = lm_task(torch, tmp, "language_modeling")
        torch.manual_seed(280)
        with torch.device("cuda"):
            model = task.build_model()
        n_params = sum(p.numel() for p in model.parameters())
        tokens = torch.from_numpy(unit_rows(LM_B, LM_T, 281)).long().cuda()
        nlls = {}
        for dtype in (torch.float32, torch.bfloat16):
            lm = model.to(dtype).eval()
            eval_lm.nll(lm, tokens)
            torch.cuda.synchronize()
            _build.launch_counts.clear()
            t1 = time.perf_counter()
            s, n = eval_lm.nll(lm, tokens)
            torch.cuda.synchronize()
            nlls[str(dtype)[6:]] = (float(s) / int(n), time.perf_counter() - t1,
                                    dict(_build.launch_counts))
        model = model.float().train()
        trainer = Trainer(train_cli.trainer_config(args), model, task.build_criterion())
        batches = [{"target_unit": unit_rows(LM_B, LM_T, 282 + i)} for i in range(2)]
        ms, peak, mets = timed_updates(torch, trainer, batches, "transformer_lm")
        mets = mets[-1]
        print(f"transformer_lm: {n_params / 1e6:.1f} M parameters; eval_lm's NLL over B{LM_B} x "
              f"{LM_T} tokens, "
              + ", ".join(f"{k}: {v[0]:.5f} nats ({1e3 * v[1]:.1f} ms, launches {v[2]})"
                          for k, v in nlls.items())
              + f"; update (lm_cross_entropy) bf16 forward: ms {[round(v, 1) for v in ms]}, "
                f"peak {peak:.2f} GB, loss {mets['loss']:.4f}; {smi}")
        if (any(v[2] for v in nlls.values())
                or abs(nlls["bfloat16"][0] - nlls["float32"][0]) > 0.05 * nlls["float32"][0]):
            fail(f"transformer_lm NLL: {nlls}")
        del model, trainer


def run_iddpm(torch, mods, smi):
    """Phase 27d: IDDPM over the released normalizer's Denoiser (module
    docstring). Returns the counted samples' launches."""
    from diffnorm_tpu_torch.models.diffusion import Denoiser
    from diffnorm_tpu_torch.models.gaussian_diffusion import create_diffusion

    norm, chain = mods[:2]
    diffusion, cfg = create_diffusion(learn_sigma=False, timestep_respacing=IDDPM_RESPACING)
    steps = diffusion.num_timesteps
    torch.manual_seed(283)
    with torch.device("cuda"):
        denoiser = Denoiser()
    mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
    shape = (B, T, 128)
    dtype = torch.float32

    def denoise_fn(x, t):
        out = denoiser(x.to(dtype), t.float(), mask)
        return out if dtype == torch.float64 else out.float()

    g = torch.Generator(device="cuda").manual_seed(284)
    noises = [torch.randn(shape, generator=g, device="cuda") for _ in range(steps + 1)]
    kw = dict(model_mean_type=cfg["model_mean_type"], model_var_type=cfg["model_var_type"])
    t_first, t_last = (diffusion.map_t(torch.full((B,), i, device="cuda")) for i in (steps - 1, 0))

    def sample():
        return diffusion.ddim_sample_loop(denoise_fn, shape, noise=noises, **kw)

    def flat(x):
        return x.reshape(-1, 128)

    def rel_err(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    def calls(t):
        """One Denoiser call at t through the kernels and the plain versions."""
        with torch.no_grad():
            call = denoise_fn(noises[0], t)
            with plain_versions(*mods):
                return call, denoise_fn(noises[0], t)

    def samples():
        """The sample through the kernels (counted) and the plain versions."""
        out, counts, wall = timed_decode(torch, sample, reps=1)
        with plain_versions(*mods):
            ref, _, wall_p = timed_decode(torch, sample, reps=1)
        return out, ref, {k: counts.get(k, 0) for k in want}, wall, wall_p

    want = {"rms_norm_film": 24 * steps, "wavenet_chain": 8 * steps}
    denoiser = denoiser.eval()
    call32 = calls(t_first)[1]  # the float32 reference of the bf16 call
    dtype = torch.bfloat16
    denoiser = denoiser.to(dtype)
    call, call_p = calls(t_first)
    err, err_p = rel_err(call, call32), rel_err(call_p, call32)
    last_cos = min_row_cos(torch, *map(flat, calls(t_last)))
    out, ref, counts, wall, wall_p = samples()
    cos = min_row_cos(torch, flat(out), flat(ref))
    # which kernel moves the sample: each alone through its plain version
    moved = {}
    for mod, name in ((norm, "rms_norm_film"), (chain, "wavenet_chain")):
        with plain_kernel(mod, name):
            moved[name] = min_row_cos(torch, flat(out), flat(sample()))
    busy, kernels = profile_run(torch, sample, wall)
    x0 = torch.randn(shape, generator=g, device="cuda")
    t = torch.randint(0, steps, (B,), generator=g, device="cuda")
    denoiser.train()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses, _ = diffusion.training_losses(denoise_fn, x0, t, loss_type=cfg["loss_type"],
                                          noise=noises[0], **kw)
    loss = losses["loss"].mean()
    loss.backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    gnorm = math.sqrt(sum(float(p.grad.float().square().sum()) for p in denoiser.parameters()
                          if p.grad is not None))
    print(f"IDDPM over the Denoiser ({cfg}, {IDDPM_RESPACING} of 1000 linear steps), B{B} x "
          f"T{T} x 128, bf16: ddim_sample_loop wall {wall:.4f} s ({steps} steps), launches "
          f"{counts} (expected {want}), device busy "
          + ("not measured" if busy is None else f"{100 * busy:.1f}%")
          + f"; the plain versions {wall_p:.4f} s; the samples row-cos min {cos:.6f} (bound "
          f"{IDDPM_ROW_COS}), against the sample with one kernel's plain version: "
          + ", ".join(f"{k} {v:.6f}" for k, v in moved.items())
          + f"; one Denoiser call at t {int(t_first[0])}: its error against the float32 "
          f"plain call (norm of the difference over the norm) {err:.4e}, the plain versions' "
          f"{err_p:.4e} (bound {IDDPM_ERR_RATIO['call']}x), row-cos min "
          f"{min_row_cos(torch, flat(call), flat(call_p)):.6f} between them; at t "
          f"{int(t_last[0])} row-cos min {last_cos:.6f} (bound "
          f"{IDDPM_CALL_ROW_COS['bfloat16']}); training_losses forward and backward "
          f"{ms:.1f} ms, loss {loss.item():.5f}, gnorm {gnorm:.4f}; {smi}")
    if (counts != want or cos < IDDPM_ROW_COS or err > IDDPM_ERR_RATIO["call"] * err_p
            or last_cos < IDDPM_CALL_ROW_COS["bfloat16"] or not torch.isfinite(out).all()
            or not math.isfinite(gnorm)):
        fail(f"IDDPM: launches {counts}, row-cos {cos:.6f}, call error {err:.4e} against "
             f"{err_p:.4e}, row-cos at t 0 {last_cos:.6f}, gnorm {gnorm}")
    launches = counts

    # float32, and a float64 reference of its sample
    denoiser.zero_grad(set_to_none=True)
    dtype = torch.float32
    denoiser = denoiser.to(dtype).eval()
    call_cos = min_row_cos(torch, *map(flat, calls(t_first)))
    out, ref, counts, wall, wall_p = samples()
    dtype = torch.float64
    denoiser = denoiser.to(dtype)
    with float64_versions(norm, chain):
        ref64 = sample()
    err, err_p = rel_err(out.double(), ref64), rel_err(ref.double(), ref64)
    print(f"IDDPM over the Denoiser, float32: ddim_sample_loop wall {wall:.4f} s, launches "
          f"{counts} (expected {want}); the plain versions {wall_p:.4f} s; one Denoiser call at "
          f"t {int(t_first[0])} against the plain versions row-cos min {call_cos:.6f} (bound "
          f"{IDDPM_CALL_ROW_COS['float32']}); the sample's error against the float64 one "
          f"{err:.4e}, the plain versions' {err_p:.4e} (bound {IDDPM_ERR_RATIO['sample']}x), "
          f"row-cos min {min_row_cos(torch, flat(out), flat(ref)):.6f} between them; {smi}")
    if (counts != want or call_cos < IDDPM_CALL_ROW_COS["float32"]
            or err > IDDPM_ERR_RATIO["sample"] * err_p or not torch.isfinite(out).all()):
        fail(f"IDDPM float32: launches {counts}, row-cos {call_cos:.6f}, sample error "
             f"{err:.4e} against {err_p:.4e}")
    del denoiser
    return {k: n + counts[k] for k, n in launches.items()}


def run_moe(torch, smi):
    """Phase 27e: BaseLayer's bf16 forward, sinkhorn_routing on the card
    against the CPU, balanced_assignment_host on the host."""
    import numpy as np

    from diffnorm_tpu_torch.models.moe import BaseLayer, balanced_assignment_host, sinkhorn_routing

    torch.manual_seed(285)
    with torch.device("cuda"):
        layer = BaseLayer(MOE_DIM, MOE_FFN, MOE_EXPERTS, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(286)
    x = torch.randn(MOE_TOKENS, MOE_DIM, generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        out = layer(x)
        ms = cuda_time_eager_ms(lambda: layer(x), iters=5, reps=3)
        scores = x.float() @ layer.expert_centroids.float().T
        ids = sinkhorn_routing(scores)
        ids_cpu = sinkhorn_routing(scores.cpu())
    agree = (ids.cpu() == ids_cpu).float().mean().item()
    balance = torch.bincount(ids, minlength=MOE_EXPERTS).tolist()
    t1 = time.perf_counter()
    host = balanced_assignment_host(scores.cpu().numpy())
    host_s = time.perf_counter() - t1
    flops = 2.0 * MOE_TOKENS * MOE_DIM * MOE_FFN * 2
    bound_ms, bound_by = bound(2 * x.numel() * 2 + 2 * layer.experts_w1.numel() * 2, flops,
                               BF16_FLOP_PER_S)
    print(f"BaseLayer {MOE_DIM} x FF {MOE_FFN}, {MOE_EXPERTS} experts, {MOE_TOKENS} tokens, bf16 "
          f"forward: {ms:.4f} ms (the experts' products {flops / 1e9:.1f} GFLOP, bound "
          f"{bound_ms:.4f} ms by {bound_by}); sinkhorn_routing on the card against the CPU: "
          f"{agree:.5f} of the tokens equal, counts {balance}; balanced_assignment_host on the "
          f"host {host_s:.3f} s, counts {np.bincount(host).tolist()}; {smi}")
    if (agree < MOE_AGREE or balance != [MOE_TOKENS // MOE_EXPERTS] * MOE_EXPERTS
            or not torch.isfinite(out).all()
            or np.bincount(host, minlength=MOE_EXPERTS).tolist()
            != [MOE_TOKENS // MOE_EXPERTS] * MOE_EXPERTS):
        fail(f"MoE: agreement {agree:.5f}, counts {balance}")


def write_unit_manifests(root: Path, rng):
    """{split}.tsv translation manifests with 100-400 units a target."""
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    for split, n in LM_CLI_UTTS.items():
        rows = []
        for i in range(n):
            units = rng.integers(0, SEDD_VOCAB - 4, size=int(rng.integers(100, 401)))
            rows.append({"id": f"{split}{i}", "src_audio": "none.npy", "src_n_frames": 1,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)


def run_sedd_lm_cli(torch, smi):
    """Phase 27f: cli.train -> cli.validate (sedd_lm) and cli.train ->
    cli.eval_lm (language_modeling) at LM_CLI_LAYERS layers, bf16, blocks of
    1024 tokens."""
    import numpy as np

    from diffnorm_tpu_torch.cli import eval_lm, validate
    from diffnorm_tpu_torch.cli import train as train_cli

    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_unit_manifests(tmp, np.random.default_rng(287))
        blocks = ["--tokens-per-sample", "1024", "--sample-break-mode", "none"]
        for task, depth in (("sedd_lm", "--sedd-depth"), ("language_modeling", "--decoder-layers")):
            flags = [str(tmp), "--task", task, depth, str(LM_CLI_LAYERS), *blocks]
            lines = LogLines()
            logging.getLogger("diffnorm_tpu_torch.train").addHandler(lines)
            t0 = time.perf_counter()
            rc = train_cli.main(flags + ["--save-dir", str(tmp / task), "--max-update", "2",
                                         "--max-tokens", "8192", "--dtype", "bfloat16",
                                         "--warmup-updates", "4000", "--log-interval", "1"])
            walls[f"cli.train {task}"] = time.perf_counter() - t0
            logging.getLogger("diffnorm_tpu_torch.train").removeHandler(lines)
            if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines.lines):
                fail(f"cli.train {task}: rc {rc}, log {lines.lines[-3:]}")
            step = str(tmp / task / "step_000000002")
            if task == "sedd_lm":
                lines = LogLines()
                logging.getLogger("diffnorm_tpu_torch.validate").addHandler(lines)
                t0 = time.perf_counter()
                rc = validate.main(flags + ["--path", step, "--dtype", "bfloat16"])
                walls["cli.validate sedd_lm"] = time.perf_counter() - t0
                logging.getLogger("diffnorm_tpu_torch.validate").removeHandler(lines)
                got = re.findall(r"^dev \| .*loss (\S+)", "\n".join(lines.lines), re.M)
                if rc != 0 or not got or not math.isfinite(float(got[-1])):
                    fail(f"cli.validate sedd_lm: rc {rc}, {lines.lines[-2:]}")
                walls["validation loss"] = float(got[-1])
                continue
            args = flags + ["--path", step, "--gen-subset", "test", "--dtype", "bfloat16"]
            stdout, sys.stdout = sys.stdout, io.StringIO()
            t0 = time.perf_counter()
            try:
                rc = eval_lm.main(args)
            finally:
                printed = sys.stdout.getvalue().strip()
                sys.stdout = stdout
            walls["cli.eval_lm"] = time.perf_counter() - t0
            avg, n = eval_lm.evaluate(eval_lm.parse_args(args))
            want = f"Loss (nats): {avg:.4f}, Perplexity: {math.exp(avg):.2f}"
            if rc != 0 or printed.splitlines()[-1] != want:
                fail(f"cli.eval_lm: {printed[-200:]!r} against the in-process {want!r}")
            walls["eval_lm"] = f"{printed.splitlines()[-1]} over {n} tokens"
    print(f"SEDD and unit LM CLIs ({LM_CLI_LAYERS} layers, bf16, blocks of 1024 over "
          f"{LM_CLI_UTTS} utterances of 100-400 units): "
          + ", ".join(f"{k} {v:.4g}" + (" s" if k.startswith("cli") else "")
                      if isinstance(v, float) else f"{k}: {v}" for k, v in walls.items())
          + f"; cli.eval_lm's line equal to the in-process evaluation; {smi}")


def run_sedd_lm(torch, mods, smi):
    """Phase 27: SEDD, the unit LM, IDDPM and MoE (module docstring).
    Returns the counted runs' launches by JSON row."""
    t0 = time.perf_counter()
    launches = run_sedd_decode(torch, mods, smi)
    run_sedd_lm_train(torch, smi)
    for name, n in run_iddpm(torch, mods, smi).items():
        launches[name] = launches.get(name, 0) + n
    run_moe(torch, smi)
    run_sedd_lm_cli(torch, smi)
    print(f"phase SEDD, unit LM, IDDPM, MoE: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches}; {smi}")
    return launches


# Phase 28: wav2vec2 and HuBERT pretraining and the CTC fine-tune (module
# docstring), at base width (768 x 12, FFN 3072, the released conv extractor),
# seeded, float32 (the models' default type). An update's rows are cropped to
# the recipes' 250,000-sample canvas (780 frames); the long forms are 45 s and
# 32 s (2249 and 1599 frames, past the 2048 keys where the encoder's
# self-attention goes through flash_attention).
AUDIO_TRAIN_B, AUDIO_TRAIN_SAMPLES = 4, 250_000
AUDIO_LONG_SAMPLES = (720_000, 512_000)
AUDIO_LONG_FRAMES = (2249, 1599)
AUDIO_FLASH = 12  # the encoder's self-attentions a forward
HUBERT_UNITS, CTC_LETTERS = 500, 28  # dictionaries of 504 and 32 symbols
# kernels against the plain versions on the same weights and inputs: the
# float32 kernel's three tf32 passes keep float32 accuracy (rows within
# 1e-5 of the plain versions' through 12 layers); bf16 rounds P and V
AUDIO_ROW_COS = {"float32": 0.99999, "bfloat16": 0.999}
AUDIO_LOSS_REL = 1e-4
AUDIO_LOGIT_ATOL = 1e-3  # the contrastive logits (cosines / 0.1, in [-10, 10])
# greedy CTC tokens over every frame: an argmax flips where two letters'
# log-probabilities are within the kernels' rounding
CTC_TOKENS_EQUAL = {"float32": 0.999, "bfloat16": 0.98}
AUDIO_CLI_LAYERS = 2  # the CLIs' depth, where checkpoints are written
AUDIO_CLI_UTTS = {"train": 12, "dev": 4, "test": 4}
HUBERT_FLAGS = ["--mask-prob", "0.8"]
W2V_FLAGS = ["--num-negatives", "100", "--loss-weights", "[0.1,10]"]
CTC_FLAGS = ["--apply-mask", "--mask-prob", "0.65", "--mask-channel-prob", "0.5",
             "--mask-channel-length", "64", "--feature-grad-mult", "0", "--dropout", "0.1",
             "--attention-dropout", "0.1", "--encoder-layerdrop", "0.1"]
CTC_TRAIN_FLAGS = ["--freeze-finetune-updates", "1"]  # cli.train's alone


def audio_task(torch, data, task, *extra):
    """The port's cli.train arguments and task of --task `task` over `data`
    (float32, the recipes' Adam)."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.tasks import TASKS

    args = train_cli.parse_args([str(data), "--task", task, "--max-update", "4",
                                 "--warmup-updates", "4000", "--adam-betas", "(0.9,0.98)",
                                 "--adam-eps", "1e-6", "--clip-norm", "10",
                                 "--target-code-size", str(HUBERT_UNITS), *extra])
    return args, TASKS[task](args)


def audio_waveforms(rng, lengths, canvas=None):
    """0.1-scaled normal waveforms [B, canvas] zero past each length."""
    import numpy as np

    canvas = canvas or max(lengths)
    wav = (rng.standard_normal((len(lengths), canvas), dtype=np.float32) * 0.1)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    return wav, np.asarray(lengths, np.int32)


def audio_batch(task, rng, lengths, labels=False, letters=0):
    """A batch the task prepares on the host (its draws timed): waveforms,
    frame labels in [4, K) over the valid frames (HuBERT) or `letters`
    letters a row ending in EOS (CTC). Returns (batch, host seconds)."""
    import numpy as np

    from diffnorm_tpu_torch.data.hubert_dataset import host_frames_for_samples

    wav, lens = audio_waveforms(rng, lengths)
    batch = {"src_tokens": wav, "src_lengths": lens, "nsentences": len(lengths)}
    if labels:
        n = host_frames_for_samples(wav.shape[1])
        target = rng.integers(4, 4 + HUBERT_UNITS, (len(lengths), n)).astype(np.int64)
        for i, x in enumerate(lens):
            target[i, host_frames_for_samples(int(x)):] = -1
        batch.update(target=target, ntokens=int((target >= 0).sum()))
    if letters:
        batch["src_tokens"] = wav[..., None]
        tgt = rng.integers(4, 4 + CTC_LETTERS, (len(lengths), letters)).astype(np.int32)
        tgt[:, -1] = 2
        batch.update(target=tgt, ntokens=int(tgt.size))
    t0 = time.perf_counter()
    batch = task.prepare_batch(batch, rng)
    return batch, time.perf_counter() - t0


def audio_update(torch, args, task, model, batches, what):
    """Updates of `model` over `batches` (the first a warm-up): ms, peak,
    busy share of a profiled update and its launches. Training forwards
    drop out, so no kernel is reached."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer

    trainer = Trainer(train_cli.trainer_config(args), model, task.build_criterion())
    _build.launch_counts.clear()
    ms, peak, mets = timed_updates(torch, trainer, batches, what)
    counts = dict(_build.launch_counts)
    busy, _ = profile_run(torch, lambda: trainer.train_step([batches[-1]]), ms[-1] / 1e3)
    if counts:
        fail(f"{what} update launched {counts} (attention dropout keeps training forwards "
             f"off the kernels)")
    return trainer, ms, peak, mets[-1], busy


def long_form_check(torch, model, criterion, batch, mods, what, dtype_name, compare, smi):
    """The eval forward and the criterion's loss on a long-form batch
    through the kernels (launches counted) and through the plain versions.
    `compare(out, ref, batch)` -> (agreement, its bound, text). Returns the
    flash launches."""
    from diffnorm_tpu_torch.ops import _build

    up = {k: torch.as_tensor(v).cuda() for k, v in batch.items()
          if k not in ("nsentences", "ntokens")}
    model.eval()
    with torch.no_grad():
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t1 = time.perf_counter()
        loss, mets = criterion(model, up)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = dict(_build.launch_counts)
        out = model_outputs(model, up)
        with plain_versions(*mods):
            ref_loss, _ = criterion(model, up)
            ref = model_outputs(model, up)
    key = "flash_attention_f32" if dtype_name == "float32" else "flash_attention"
    frames = out["mask"].sum(1).tolist()
    if frames != list(AUDIO_LONG_FRAMES):
        fail(f"{what} long form: valid frames {frames}, expected {list(AUDIO_LONG_FRAMES)}")
    rel = abs(loss.item() - ref_loss.item()) / max(abs(ref_loss.item()), 1e-12)
    agree, bound_, text = compare(out, ref, up)
    print(f"{what} long form, {dtype_name}, B2 x {list(AUDIO_LONG_SAMPLES)} samples "
          f"({list(AUDIO_LONG_FRAMES)} frames): the criterion's forward {1e3 * wall:.1f} ms, "
          f"launches {counts} (expected {AUDIO_FLASH}, the JSON row {key}); against the plain "
          f"versions {text}, loss {loss.item():.5f} vs {ref_loss.item():.5f} (rel {rel:.2e}, "
          f"bound {AUDIO_LOSS_REL}); {smi}")
    if (counts != {"flash_attention": AUDIO_FLASH} or agree < bound_ or rel > AUDIO_LOSS_REL
            or not math.isfinite(loss.item())):
        fail(f"{what} long form: launches {counts}, agreement {agree}, loss rel {rel:.2e}")
    return {key: AUDIO_FLASH}


def model_outputs(model, up):
    """The model's eval outputs on an uploaded batch (the criterion's
    inputs)."""
    keys = {"HubertPretrainModule": ("src_tokens", "src_lengths", "mask_indices"),
            "Wav2Vec2PretrainModule": ("src_tokens", "src_lengths", "mask_indices",
                                       "masked_pos", "masked_valid", "neg_idxs")}
    return model(*(up[k] for k in keys[type(model).__name__]))


def run_hubert_pretrain(torch, mods, smi):
    """Phase 28a: hubert_base, one update at B4 x 250,000 samples, then the
    long-form validation forward. Returns its launches."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        args, task = audio_task(torch, tmp, "hubert_pretraining", *HUBERT_FLAGS)
        torch.manual_seed(288)
        with torch.device("cuda"):
            model = task.build_model()
        n_params = sum(p.numel() for p in model.parameters())
        rng = np.random.default_rng(288)
        drawn = [audio_batch(task, rng, [AUDIO_TRAIN_SAMPLES] * AUDIO_TRAIN_B, labels=True)
                 for _ in range(2)]
        trainer, ms, peak, mets, busy = audio_update(
            torch, args, task, model, [b for b, _ in drawn], "hubert_base")
        host_ms = [round(1e3 * s, 2) for _, s in drawn]
        print(f"hubert_base update (hubert, recipe dropouts, LayerDrop 0.05, feature_grad_mult "
              f"0.1): {n_params / 1e6:.1f} M parameters, K = {len(task.tgt_dict)}, B"
              f"{AUDIO_TRAIN_B} x {AUDIO_TRAIN_SAMPLES} samples (780 frames), float32: ms per "
              f"update {[round(v, 1) for v in ms]} (the first a warm-up), peak {peak:.2f} GB, "
              f"busy " + ("not measured" if busy is None else f"{100 * busy:.1f}%")
              + f", loss {mets['loss']:.4f}, masked frames {mets['count_m']:.0f}, the host's "
              f"mask draw {host_ms} ms (two batches); {smi}")
        del trainer
        batch, _ = audio_batch(task, rng, list(AUDIO_LONG_SAMPLES), labels=True)

        def compare(out, ref, up):
            valid = out["mask"]
            cos = rows_cos(torch, out["logits"], ref["logits"], valid)
            return cos, AUDIO_ROW_COS["float32"], (f"logits row-cos min {cos:.7f} (bound "
                                                   f"{AUDIO_ROW_COS['float32']})")

        launches = long_form_check(torch, model, task.build_criterion(), batch, mods,
                                   "hubert_base validation", "float32", compare, smi)
        del model
    return launches


def run_wav2vec2_pretrain(torch, mods, smi):
    """Phase 28b: wav2vec2_base, one update, then the long-form check on
    the contrastive logits' finite entries. Returns its launches."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        args, task = audio_task(torch, tmp, "audio_pretraining", *W2V_FLAGS)
        torch.manual_seed(289)
        with torch.device("cuda"):
            model = task.build_model()
        n_params = sum(p.numel() for p in model.parameters())
        rng = np.random.default_rng(289)
        drawn = [audio_batch(task, rng, [AUDIO_TRAIN_SAMPLES] * AUDIO_TRAIN_B)
                 for _ in range(2)]
        trainer, ms, peak, mets, busy = audio_update(
            torch, args, task, model, [b for b, _ in drawn], "wav2vec2_base")
        host_ms = [round(1e3 * s, 2) for _, s in drawn]
        slots = drawn[0][0]["masked_pos"].shape[1]
        print(f"wav2vec2_base update (wav2vec, 100 negatives, loss weights [0.1, 10], the "
              f"recipe dropouts): {n_params / 1e6:.1f} M parameters, B{AUDIO_TRAIN_B} x "
              f"{AUDIO_TRAIN_SAMPLES} samples, {slots} masked slots a row, float32: ms per "
              f"update {[round(v, 1) for v in ms]} (the first a warm-up), peak {peak:.2f} GB, "
              f"busy " + ("not measured" if busy is None else f"{100 * busy:.1f}%")
              + f", loss {mets['loss']:.4f}, prob perplexity {mets['prob_perplexity']:.1f}, "
              f"the host's mask and negative draws {host_ms} ms (two batches); {smi}")
        del trainer
        batch, _ = audio_batch(task, rng, list(AUDIO_LONG_SAMPLES))

        def compare(out, ref, up):
            a, b = out["logits"], ref["logits"]
            same_inf = torch.equal(torch.isfinite(a), torch.isfinite(b))
            fin = torch.isfinite(a) & up["masked_valid"][..., None]
            err = (a[fin] - b[fin]).abs().max().item()
            ok = 1.0 if same_inf and err <= AUDIO_LOGIT_ATOL else 0.0
            return ok, 1.0, (f"contrastive logits: -inf at the same places {same_inf} "
                             f"({(~torch.isfinite(a)).sum().item()} removed negatives), the "
                             f"finite ones max err {err:.2e} (bound {AUDIO_LOGIT_ATOL})")

        launches = long_form_check(torch, model, task.build_criterion(), batch, mods,
                                   "wav2vec2_base validation", "float32", compare, smi)
        del model
    return launches


def run_ctc_finetune(torch, mods, smi):
    """Phase 28c: hubert_ctc at base width, one fine-tune update with the
    masks, then the long-form greedy decode in float32 and bf16 against the
    plain versions. Returns its launches."""
    import numpy as np

    from diffnorm_tpu_torch.generate.ctc import ctc_greedy_decode

    with tempfile.TemporaryDirectory() as tmp:
        args, task = audio_task(torch, tmp, "audio_finetuning", *CTC_FLAGS, *CTC_TRAIN_FLAGS,
                                "--target-code-size", str(CTC_LETTERS))
        torch.manual_seed(290)
        with torch.device("cuda"):
            model = task.build_model()
        rng = np.random.default_rng(290)
        drawn = [audio_batch(task, rng, [AUDIO_TRAIN_SAMPLES] * AUDIO_TRAIN_B, letters=200)
                 for _ in range(2)]
        frozen = model.w2v_model.layer_0.fc1.weight.detach().clone()
        trainer, ms, peak, mets, busy = audio_update(
            torch, args, task, model, [b for b, _ in drawn], "hubert_ctc")
        moved = not torch.equal(frozen, model.w2v_model.layer_0.fc1.weight)
        print(f"hubert_ctc fine-tune update (ctc, time and channel masks, feature_grad_mult 0, "
              f"freeze_finetune_updates 1, LayerDrop 0.1): vocab {len(task.tgt_dict)}, "
              f"B{AUDIO_TRAIN_B} x {AUDIO_TRAIN_SAMPLES} samples, 200 letters a row, float32: "
              f"ms per update {[round(v, 1) for v in ms]} (the first frozen), peak {peak:.2f} "
              f"GB, busy " + ("not measured" if busy is None else f"{100 * busy:.1f}%")
              + f", loss {mets['loss']:.4f}, the encoder moved after the frozen update "
              f"{moved}; {smi}")
        if not moved:
            fail("hubert_ctc: the encoder did not train after freeze_finetune_updates")
        del trainer, model
        # the decode on a fresh seeded model
        torch.manual_seed(291)
        with torch.device("cuda"):
            model = task.build_model()
        wav, lens = audio_waveforms(rng, list(AUDIO_LONG_SAMPLES))
        src = torch.from_numpy(wav).cuda()[..., None]
        lengths = torch.from_numpy(lens).cuda()
        launches = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            m = model.to(dtype).eval()
            out, counts, wall = timed_decode(torch, lambda: ctc_greedy_decode([m], src, lengths),
                                             reps=1)
            with plain_versions(*mods):
                ref = ctc_greedy_decode([m], src, lengths)
            with torch.no_grad():
                fwd = m(src, lengths)
                valid, logits = fwd["mask"], fwd["logits"]
                with plain_versions(*mods):
                    ref_logits = m(src, lengths)["logits"]
            cos = rows_cos(torch, logits, ref_logits, valid)
            equal = (out[0] == ref[0])[valid].float().mean().item()
            argmax = (logits.argmax(-1) == ref_logits.argmax(-1))[valid].float().mean().item()
            # seeded weights: how much the logits move from frame to frame
            # against their spread over the letters (a 12-layer random
            # encoder gives nearly the same output at every frame)
            first = logits[0, :AUDIO_LONG_FRAMES[0]].float()
            spread = (first.std(0).mean() / first.std(1).mean()).item()
            emitted = (out[0] != 1).sum().item()
            key = "flash_attention_f32" if dtype == torch.float32 else "flash_attention"
            print(f"hubert_ctc greedy decode, long form, {name}: B2 x {list(AUDIO_LONG_SAMPLES)}"
                  f" samples, wall {1e3 * wall:.1f} ms, launches {counts} (expected "
                  f"{AUDIO_FLASH} a forward, the JSON row {key}); against the plain versions "
                  f"frame tokens equal {equal:.5f} and frame argmax equal {argmax:.5f} (bound "
                  f"{CTC_TOKENS_EQUAL[name]} each), {emitted} tokens emitted, the logits' "
                  f"spread over frames {spread:.4f} of theirs over letters, logits row-cos "
                  f"min {cos:.7f} (bound {AUDIO_ROW_COS[name]}); {smi}")
            if (counts != {"flash_attention": AUDIO_FLASH} or min(equal, argmax)
                    < CTC_TOKENS_EQUAL[name] or cos < AUDIO_ROW_COS[name]):
                fail(f"hubert_ctc decode {name}: launches {counts}, tokens equal {equal}, "
                     f"row-cos {cos}")
            launches[key] = launches.get(key, 0) + AUDIO_FLASH
        del model
    return launches


def write_audio_cli_corpus(root: Path, rng):
    """16 kHz WAVs of 3-5 s under pre/ (a wav2vec manifest, 50 Hz labels over
    500 units, dict.km.txt) and ft/ (S2T manifests of 6-20 letters a row,
    config.yaml with use_audio_input and dict.ltr.txt)."""
    import numpy as np

    from diffnorm_tpu_torch.data.s2t_dataset import write_s2t_manifest

    pre, ft = root / "pre", root / "ft"
    pre.mkdir()
    ft.mkdir()
    (pre / "dict.km.txt").write_text("".join(f"{i} 1\n" for i in range(HUBERT_UNITS)))
    letters = list("abcdefghijklmnopqrstuvwxyz'|")
    (ft / "dict.ltr.txt").write_text("".join(f"{c} 1\n" for c in letters))
    (ft / "config.yaml").write_text("use_audio_input: true\nvocab_filename: dict.ltr.txt\n")
    for split, n in AUDIO_CLI_UTTS.items():
        lines, labels, rows = [str(pre)], [], []
        for i in range(n):
            size = int(rng.integers(48_000, 80_001))
            pcm = (rng.standard_normal(size) * 3000).astype(np.int16)
            write_wav_pcm(pre / f"{split}{i}.wav", pcm)
            write_wav_pcm(ft / f"{split}{i}.wav", pcm)
            lines.append(f"{split}{i}.wav\t{size}")
            labels.append(" ".join(map(str, rng.integers(0, HUBERT_UNITS, size // 320))))
            rows.append(dict(id=f"{split}{i}", audio=f"{split}{i}.wav", n_frames=size,
                             tgt_text=" ".join(rng.choice(letters, int(rng.integers(6, 21))))))
        (pre / f"{split}.tsv").write_text("\n".join(lines) + "\n")
        (pre / f"{split}.km").write_text("\n".join(labels) + "\n")
        write_s2t_manifest(str(ft / f"{split}.tsv"), rows)
    return pre, ft


def fairseq_hubert_ctc_state(torch, seed: int, layers: int, vocab: int) -> SeededStateDict:
    """A fairseq HubertCtc state dict at base width (w2v_encoder.w2v_model.*,
    the pos_conv weight-normed over dim 2, the pretraining heads left in,
    w2v_encoder.proj) with the buffers' version keys."""
    sd = SeededStateDict(torch, seed)
    p = "w2v_encoder.w2v_model"
    cin = 1
    for i, (dim, k, _) in enumerate(((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2):
        sd.conv(f"{p}.feature_extractor.conv_layers.{i}.0", dim, cin, k, bias=False)
        cin = dim
    sd.norm(f"{p}.feature_extractor.conv_layers.0.2", 512)
    sd.norm(f"{p}.layer_norm", 512)
    sd.linear(f"{p}.post_extract_proj", 768, 512)
    sd.normal(f"{p}.encoder.pos_conv.0.weight_g", (1, 1, 128), 0.1, 1.0)
    sd.weight(f"{p}.encoder.pos_conv.0.weight_v", 768, 48, 128)
    sd.normal(f"{p}.encoder.pos_conv.0.bias", (768,), 0.1)
    sd.norm(f"{p}.encoder.layer_norm", 768)
    for n in range(layers):
        q = f"{p}.encoder.layers.{n}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.linear(f"{q}.self_attn.{proj}", 768, 768)
        sd.norm(f"{q}.self_attn_layer_norm", 768)
        sd.linear(f"{q}.fc1", 3072, 768)
        sd.linear(f"{q}.fc2", 768, 3072)
        sd.norm(f"{q}.final_layer_norm", 768)
    sd.normal(f"{p}.mask_emb", (768,), 1.0)
    sd.normal(f"{p}.label_embs_concat", (504, 256), 1.0)
    sd.linear(f"{p}.final_proj", 256, 768)
    sd.linear("w2v_encoder.proj", vocab, 768)
    sd.put(f"{p}.encoder.version", [2.0])
    return sd


def cli_run(mod, argv, logger_name):
    """mod.main(argv) with its logger's lines kept: (rc, wall, lines)."""
    lines = LogLines()
    logging.getLogger(logger_name).addHandler(lines)
    t0 = time.perf_counter()
    try:
        rc = mod.main(argv)
    finally:
        logging.getLogger(logger_name).removeHandler(lines)
    return rc, time.perf_counter() - t0, lines.lines


def run_audio_cli(torch, smi):
    """Phase 28d: cli.train hubert_pretraining and audio_pretraining, then
    audio_finetuning --w2v-path on the HuBERT step directory (use_audio_input)
    at AUDIO_CLI_LAYERS layers -> cli.validate -> cli.generate (CTC) against
    the in-process decode of the same batches; cli.convert_checkpoint --type
    hubert_ctc on a seeded fairseq state dict, loaded into the model."""
    import numpy as np

    from diffnorm_tpu_torch.cli import convert_checkpoint, generate, validate
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli.generate import strip_special
    from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
    from diffnorm_tpu_torch.generate.ctc import ctc_greedy_decode
    from diffnorm_tpu_torch.tasks import TASKS
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import from_jax_variables

    walls = {}
    depth = ["--encoder-layers", str(AUDIO_CLI_LAYERS)]
    common = ["--max-update", "2", "--warmup-updates", "4000", "--log-interval", "1",
              "--max-sample-size", "80000", "--max-tokens", "320000", *depth]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pre, ft = write_audio_cli_corpus(tmp, np.random.default_rng(291))
        for task, extra in (("hubert_pretraining", HUBERT_FLAGS), ("audio_pretraining", W2V_FLAGS)):
            rc, walls[f"cli.train {task}"], lines = cli_run(
                train_cli, [str(pre), "--task", task, "--save-dir", str(tmp / task), *common,
                            *extra], "diffnorm_tpu_torch.train")
            if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines):
                fail(f"cli.train {task}: rc {rc}, {lines[-3:]}")
        w2v = tmp / "hubert_pretraining" / "step_000000002"
        ft_flags = [str(ft), "--task", "audio_finetuning", *CTC_FLAGS, *depth]
        rc, walls["cli.train audio_finetuning --w2v-path"], lines = cli_run(
            train_cli, ft_flags + ["--save-dir", str(tmp / "ctc"), "--w2v-path", str(w2v),
                                   *common, *CTC_TRAIN_FLAGS], "diffnorm_tpu_torch.train")
        if rc != 0 or "saved checkpoint at step 2" not in "\n".join(lines):
            fail(f"cli.train audio_finetuning: rc {rc}, {lines[-3:]}")
        step = tmp / "ctc" / "step_000000002"
        rc, walls["cli.validate audio_finetuning"], lines = cli_run(
            validate, ft_flags + ["--path", str(step), "--valid-subset", "dev", "--max-tokens",
                                  "320000"], "diffnorm_tpu_torch.validate")
        got = re.findall(r"^dev \| .*loss (\S+)", "\n".join(lines), re.M)
        if rc != 0 or not got or not math.isfinite(float(got[-1])):
            fail(f"cli.validate audio_finetuning: rc {rc}, {lines[-2:]}")
        out = tmp / "gen"
        rc, walls["cli.generate audio_finetuning"], _ = cli_run(
            generate, ft_flags + ["--path", str(step), "--gen-subset", "test", "--max-tokens",
                                  "320000", "--dtype", "float32", "--results-path", str(out)],
            "diffnorm_tpu_torch.generate")
        printed = {line.split("\t")[0][2:]: line.split("\t")[-1]
                   for line in (out / "generate-test.txt").read_text().splitlines()
                   if line.startswith("D-")}
        args = train_cli.parse_args(ft_flags + ["--max-update", "1"])
        task = TASKS["audio_finetuning"](args)
        with torch.device("cuda"):
            model = task.build_model()
        from_jax_variables(model, load_variables(str(step)))
        model.eval()
        want = {}
        ds = task.dataset("test")
        for batch in EpochBatchIterator(ds, max_tokens=320000, shuffle=False).next_epoch_itr():
            tokens, _ = ctc_greedy_decode([model], torch.from_numpy(batch["src_tokens"]).cuda(),
                                          torch.from_numpy(batch["src_lengths"]).cuda())
            for i, sid in enumerate(batch["id"].tolist()):
                want[str(sid)] = strip_special(tokens[i].cpu().numpy(), task.tgt_dict)
        if rc != 0 or printed != want:
            fail(f"cli.generate CTC: rc {rc}, lines {printed} against in process {want}")
        del model
        sd = fairseq_hubert_ctc_state(torch, 292, AUDIO_CLI_LAYERS, 4 + CTC_LETTERS)
        torch.save(fairseq_envelope(torch, dict(sd), criterion="ctc"), tmp / "ctc.pt")
        rc, walls["cli.convert_checkpoint hubert_ctc"], lines = cli_run(
            convert_checkpoint, ["--type", "hubert_ctc", "--input", str(tmp / "ctc.pt"),
                                 "--output", str(tmp / "ctc_conv")],
            "diffnorm_tpu_torch.convert_checkpoint")
        with torch.device("cuda"):
            model = TASKS["audio_finetuning"](train_cli.parse_args(
                [str(ft), "--task", "audio_finetuning", "--max-update", "1", "--apply-mask",
                 *depth])).build_model()
        from_jax_variables(model, load_variables(str(tmp / "ctc_conv")))
        if rc != 0:
            fail(f"cli.convert_checkpoint hubert_ctc: rc {rc}, {lines[-2:]}")
    print(f"wav2vec2 / HuBERT CLIs ({AUDIO_CLI_LAYERS} layers, float32, "
          f"{AUDIO_CLI_UTTS} utterances of 3-5 s): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; validation loss {float(got[-1]):.4f}; cli.generate's {len(printed)} D- lines "
          f"equal to the in-process greedy decode; the converted fairseq CTC checkpoint loads; "
          f"{smi}")


def run_audio_pretrain(torch, mods, smi):
    """Phase 28 (module docstring). Returns the counted runs' launches by
    JSON row."""
    t0 = time.perf_counter()
    launches = {}
    for fn in (run_hubert_pretrain, run_wav2vec2_pretrain, run_ctc_finetune):
        for name, n in fn(torch, mods, smi).items():
            launches[name] = launches.get(name, 0) + n
    run_audio_cli(torch, smi)
    print(f"phase wav2vec2 / HuBERT: {time.perf_counter() - t0:.1f} s, launches {launches}; "
          f"{smi}")
    return launches


# 29. TranSpeech's baseline normalization, lightconv / dynamicconv, the MMA
# expected alignment and the runtime remainder
SN_UTTS = 32  # utterances a split, two splits (a CVSS-sized split's share of a batch job)
SN_SECONDS = (2.0, 8.0)  # each utterance's length at 16 kHz, f0 90-240 Hz
SN_SR = 16000
SN_F0_OFF = 0.05  # a median further than this from the f0 that made it counts as off
SN_F0_REL = 1e-4  # the card's medians against the --cpu run's
SN_WAV_ATOL = 1e-4  # the card's output wavs against the --cpu run's: 3 16-bit steps
CONV_SHAPE, CONV_HEADS, CONV_K = (8, 1024, 512), 8, 31  # lightconv_iwslt_de_en's widest layer
CONV_ATOL = {"float32": 1e-5}  # bf16: 2^-8 of each output (its own rounding), PERF.md
ALIGN_SHAPE, ALIGN_ATOL = (64, 128, 512), 1e-4
RT_DEPTH = 2  # the layers of the models whose checkpoints cli.train writes
RT_COMMON = ["--max-update", "2", "--dataset-size", "2", "--log-interval", "1",
             "--dtype", "bfloat16", "--seed", "42"]
RT_RUNS = (  # cli.train's dummy tasks at the archs' widths, depth cut to RT_DEPTH
    ("dummy_vae", ["--batch-size", "8", "--tokens-per-sample", "400",
                   "--vae-decoder-depth", str(RT_DEPTH)]),
    ("dummy_nar", ["--batch-size", "8", "--tokens-per-sample", "480",
                   "--encoder-layers", str(RT_DEPTH), "--decoder-layers", str(RT_DEPTH)]),
    ("dummy_ar", ["--encoder-layers", str(RT_DEPTH), "--decoder-layers", str(RT_DEPTH)]),
    ("dummy_mt", ["--encoder-layers", str(RT_DEPTH), "--decoder-layers", str(RT_DEPTH)]),
)


def synthetic_voice(rng, f0: float, seconds: float):
    """A harmonic voice at f0 with a random vibrato, breath noise and 0.1-0.4
    s of silence at each end, float32 at SN_SR."""
    import numpy as np

    n = int(seconds * SN_SR)
    t = np.arange(n) / SN_SR
    rate, depth = rng.uniform(4.0, 6.0), rng.uniform(0.01, 0.03)
    phase = 2 * np.pi * np.cumsum(f0 * (1 + depth * np.sin(2 * np.pi * rate * t))) / SN_SR
    x = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 7)) * 0.25
    x = x + rng.uniform(0.003, 0.02) * rng.normal(size=n)
    for cut in (slice(0, int(rng.uniform(0.1, 0.4) * SN_SR)),
                slice(n - int(rng.uniform(0.1, 0.4) * SN_SR), n)):
        x[cut] = 0.0
    return x.astype(np.float32)


def write_speech_norm_corpus(root: Path, rng):
    """{split: {name: the f0 that made it}} of SN_UTTS wavs a split under
    root/{train,dev}, and the seconds of audio written."""
    from diffnorm_tpu_torch.cli.generate_waveform import write_wav

    made, seconds = {}, 0.0
    for split in ("train", "dev"):
        (root / split).mkdir(parents=True)
        made[split] = {}
        for i in range(SN_UTTS):
            f0, sec = float(rng.uniform(90.0, 240.0)), float(rng.uniform(*SN_SECONDS))
            write_wav(str(root / split / f"{split}{i:03d}.wav"), synthetic_voice(rng, f0, sec),
                      SN_SR)
            made[split][f"{split}{i:03d}"] = f0
            seconds += sec
    return made, seconds


def run_speech_norm_cli(torch, smi):
    """Phase 29a: cli.speech_norm on two splits of SN_UTTS synthetic voices
    (its three passes timed), YIN's time a second of audio and its medians
    against the f0 that made each voice; then the CLI on two of those
    utterances on the card and with --cpu: the medians within SN_F0_REL, the
    output wavs within SN_WAV_ATOL."""
    import shutil

    import numpy as np

    from diffnorm_tpu_torch.cli import speech_norm
    from diffnorm_tpu_torch.data.audio import read_audio
    from diffnorm_tpu_torch.ops.speech_norm import pitch_median

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        made, seconds = write_speech_norm_corpus(tmp / "wav", np.random.default_rng(2901))
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = speech_norm.main(["--wav", str(tmp / "wav"), "--out", str(tmp / "out"),
                                   "--splits", "train,dev"])
        wall = time.perf_counter() - t1
        passes = re.findall(r"\[(\w+)\] wrote (\d+) .*\(medians (\S+) s, shift (\S+) s, "
                            r"energy (\S+) s\)", out.getvalue())
        written = sorted(p.name for p in (tmp / "out").glob("*/result/*.wav"))
        if rc != 0 or len(passes) != 2 or len(written) != 2 * SN_UTTS:
            fail(f"cli.speech_norm: rc {rc}, {len(written)} wavs, {out.getvalue()[-300:]}")
        wavs = {name: read_audio(str(tmp / "wav" / split / f"{name}.wav"))[0]
                for split in made for name in made[split]}
        for wav in list(wavs.values())[:2]:  # warm-up
            pitch_median(wav, SN_SR, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        medians = {name: pitch_median(wav, SN_SR, device="cuda") for name, wav in wavs.items()}
        torch.cuda.synchronize()
        yin_s = time.perf_counter() - t1
        f0 = {name: hz for split in made.values() for name, hz in split.items()}
        off = sorted(abs(medians[n] / f0[n] - 1) for n in f0)
        if sum(e > SN_F0_OFF for e in off) > 1:
            fail(f"cli.speech_norm: YIN medians off the voices' f0 by {off[-3:]}")
        # two utterances through the CLI on the card and with --cpu
        pair = sorted(wavs)[:2]
        (tmp / "pair" / "pair").mkdir(parents=True)
        for name in pair:
            shutil.copy(tmp / "wav" / ("train" if name.startswith("train") else "dev")
                        / f"{name}.wav", tmp / "pair" / "pair")
        runs = {}
        for where, extra in (("card", []), ("cpu", ["--cpu"])):
            with contextlib.redirect_stdout(io.StringIO()):
                speech_norm.main(["--wav", str(tmp / "pair"), "--out", str(tmp / where),
                                  "--splits", "pair", *extra])
            runs[where] = {n: read_audio(str(tmp / where / "pair" / "result" / f"{n}.wav"))[0]
                           for n in pair}
        med_rel = max(abs(pitch_median(wavs[n], SN_SR, device="cuda")
                          / pitch_median(wavs[n], SN_SR, device="cpu") - 1) for n in pair)
        wav_err = max(float(np.abs(runs["card"][n] - runs["cpu"][n]).max()) for n in pair)
        if med_rel > SN_F0_REL or wav_err > SN_WAV_ATOL:
            fail(f"cli.speech_norm card against --cpu: medians {med_rel:.3g} relative (bound "
                 f"{SN_F0_REL}), wavs {wav_err:.3g} (bound {SN_WAV_ATOL})")
    shares = "; ".join(f"{split}: medians {m} s, shift {s} s, energy {e} s"
                       for split, _, m, s, e in passes)
    print(f"cli.speech_norm: 2 x {SN_UTTS} utterances, {seconds:.1f} s of audio at 16 kHz, "
          f"{wall:.2f} s wall ({shares}); YIN on the card {1e3 * yin_s / seconds:.3f} ms a "
          f"second of audio ({yin_s:.3f} s for all); medians against the voices' f0: median "
          f"{np.median(off):.2e}, max {off[-1]:.2e} relative ({sum(e > SN_F0_OFF for e in off)} "
          f"beyond {SN_F0_OFF}); card against --cpu on 2 utterances: medians "
          f"{med_rel:.2e} relative, wavs max-abs {wav_err:.2e}; {smi}")


def conv_f64(torch, x, w, padding: str):
    """lightconv / dynamicconv's definition in float64: x [B, T, C], w [H,
    K] or [B, T, H, K]."""
    import torch.nn.functional as F

    k, h, c, t = w.shape[-1], w.shape[-2], x.shape[-1], x.shape[1]
    w = torch.softmax(w.double(), dim=-1).repeat_interleave(c // h, dim=-2)
    left = k - 1 if padding == "causal" else k // 2
    xd = F.pad(x.double(), (0, 0, left, k - 1 - left))
    return sum(xd[:, i:i + t] * w[..., i] for i in range(k))


def run_lightconv(torch, smi):
    """Phase 29b: lightconv and dynamicconv at CONV_SHAPE, causal and same,
    float32 and bf16, against their float64 definition, each timed."""
    from diffnorm_tpu_torch.ops.lightconv import dynamicconv, lightconv

    b, t, c = CONV_SHAPE
    g = torch.Generator(device="cuda").manual_seed(2902)
    x = torch.randn(b, t, c, generator=g, device="cuda")
    weights = {"lightconv": torch.randn(CONV_HEADS, CONV_K, generator=g, device="cuda"),
               "dynamicconv": torch.randn(b, t, CONV_HEADS, CONV_K, generator=g, device="cuda")}
    rows = []
    for name, fn in (("lightconv", lightconv), ("dynamicconv", dynamicconv)):
        w = weights[name]
        for padding in ("causal", "same"):
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                got = fn(xd, w, padding=padding)
                ref = conv_f64(torch, xd, w, padding)
                err = (got.double() - ref).abs()
                if dtype == torch.float32:
                    ok = err.max().item() <= CONV_ATOL["float32"]
                else:
                    ok = bool((err <= 2.0 ** -8 * ref.abs() + 1e-6).all())
                if got.dtype != dtype or not ok:
                    fail(f"{name} {padding} {dtype}: max-abs {err.max().item():.3g} against "
                         f"float64")
                ms = cuda_time_ms(lambda: fn(xd, w, padding=padding), iters=10, reps=3)
                rows.append(f"{name} {padding} {str(dtype)[6:]} {ms:.3f} ms (max-abs "
                            f"{err.max().item():.2e})")
                del got, ref, err
    print(f"lightconv / dynamicconv at {list(CONV_SHAPE)}, H {CONV_HEADS}, K {CONV_K} "
          f"(plain PyTorch on the card, K shifted multiply-adds): " + "; ".join(rows)
          + f"; {smi}")


def run_alignment(torch, smi):
    """Phase 29c: expected_alignment_from_p_choose at ALIGN_SHAPE float32
    with a padding mask against the host twin, timed."""
    import numpy as np

    from diffnorm_tpu_torch.ops.alignment import (
        expected_alignment_from_p_choose,
        expected_alignment_host,
    )

    b, tgt, src = ALIGN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(2903)
    p = torch.sigmoid(torch.randn(b, tgt, src, generator=g, device="cuda") - 1.0)
    lengths = torch.randint(src // 2, src + 1, (b,), generator=g, device="cuda")
    mask = torch.arange(src, device="cuda")[None, :] >= lengths[:, None]
    got = expected_alignment_from_p_choose(p, mask)
    host = expected_alignment_host(p.masked_fill(mask[:, None, :], 0.0).cpu().numpy())
    err = float(np.abs(got.cpu().numpy() - host).max())
    if got.shape != p.shape or err > ALIGN_ATOL or bool(got[mask[:, None, :].expand_as(got)].any()):
        fail(f"expected_alignment_from_p_choose: max-abs {err:.3g} against the host twin")
    ms = cuda_time_ms(lambda: expected_alignment_from_p_choose(p, mask), iters=2, reps=3)
    print(f"expected_alignment_from_p_choose at {list(ALIGN_SHAPE)} float32 with a padding "
          f"mask (plain PyTorch on the card, a loop over the {tgt} target rows): {ms:.3f} ms, "
          f"max-abs {err:.2e} against the host twin (bound {ALIGN_ATOL}); {smi}")


SMOKE_PLUGIN = '''
from diffnorm_tpu_torch.registry import register_task
from diffnorm_tpu_torch.tasks.dummy import DummyVAETask


@register_task("smoke_dummy_vae")
class SmokeDummyVAETask(DummyVAETask):
    """A plugin's task: dummy_vae under its own name."""
'''


def run_runtime_cli(torch, smi):
    """Phase 29d-e: cli.train on the dummy tasks of RT_RUNS, 2 updates each
    in bf16 without data on disk; cli.hydra_train on dummy_vae with dotted
    overrides; cli.train on a --user-dir plugin's task with a --config YAML;
    cli.interactive on the dummy_nar checkpoint with .npy lines. Returns the
    cli.train runs' kernel launches."""
    import numpy as np
    import yaml

    from diffnorm_tpu_torch.cli import hydra_train, interactive
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.data.dictionary import Dictionary
    from diffnorm_tpu_torch.ops import _build

    total, rows = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "smoke_plugin").mkdir()
        (tmp / "smoke_plugin" / "__init__.py").write_text(SMOKE_PLUGIN)
        vae = dict(RT_RUNS)["dummy_vae"]
        (tmp / "cfg.yaml").write_text(yaml.safe_dump({
            "task": "smoke_dummy_vae", "dtype": "bfloat16",
            "optimization": {"max_update": 2, "lr": 1e-4},
            "dataset": {"batch_size": 8, "tokens_per_sample": 400, "dataset_size": 2},
            "model": {"vae_decoder_depth": RT_DEPTH}}))
        runs = [(name, train_cli, ["--task", name, *RT_COMMON, *flags])
                for name, flags in RT_RUNS]
        runs.append(("hydra_train dummy_vae", hydra_train, [
            "--task", "dummy_vae", "optimization.max_update=2", "dataset.batch_size=8",
            "dataset.tokens_per_sample=400", "dataset.dataset_size=2", "optimization.lr=[1e-4]",
            f"model.vae_decoder_depth={RT_DEPTH}", "common.dtype=bfloat16"]))
        runs.append(("--user-dir --config", train_cli, [
            "--user-dir", str(tmp / "smoke_plugin"), "--config", str(tmp / "cfg.yaml")]))
        for i, (what, mod, argv) in enumerate(runs):
            save = tmp / f"ckpt{i}"
            if mod is hydra_train:
                argv = argv + [f"checkpoint.save_dir={save}"]
            else:
                argv = argv + ["--save-dir", str(save)]
            _build.launch_counts.clear()
            with StepTimer(torch) as timer:
                rc, wall, lines = cli_run(mod, argv, "diffnorm_tpu_torch.train")
            launches = dict(_build.launch_counts)
            valid = re.findall(r"valid \| .*loss (\S+)", "\n".join(lines))
            if (rc != 0 or not (save / "step_000000002" / "params.npz").exists() or not valid
                    or not math.isfinite(float(valid[-1]))):
                fail(f"cli.train {what}: rc {rc}, {lines[-3:]}")
            if what not in ("dummy_nar", "dummy_ar", "dummy_mt") and not launches.get(
                    "wavenet_chain"):
                fail(f"cli.train {what}: the VAE's encoder launched no wavenet_chain "
                     f"({launches})")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            rows.append(f"{what} {wall:.2f} s (ms per update "
                        f"{[round(ms, 1) for ms in timer.ms]}, valid loss {float(valid[-1]):.4g}, "
                        f"launches {launches})")
        # cli.interactive on the dummy_nar run's step directory: a .npy path a line
        nar_step = tmp / f"ckpt{[name for name, _ in RT_RUNS].index('dummy_nar')}"
        feats = np.random.default_rng(2904).normal(size=(2, 480, 80)).astype(np.float32)
        lines = []
        for k, feat in enumerate(feats):
            np.save(tmp / f"u{k}.npy", feat)
            lines.append(f"{tmp / f'u{k}.npy'}\n")
        out, stdin = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO("".join(lines))
        t1 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = interactive.main([str(tmp), "--path", str(nar_step / "step_000000002"),
                                       "--encoder-layers", str(RT_DEPTH), "--decoder-layers",
                                       str(RT_DEPTH)])
        finally:
            sys.stdin = stdin
        wall = time.perf_counter() - t1
        hyps = re.findall(r"^H-(\d+)\t(.*)$", out.getvalue(), re.M)
        symbols = set(Dictionary.unit_dictionary(1000).symbols)
        if (rc != 0 or [i for i, _ in hyps] != ["0", "1"]
                or not all(u in symbols for _, h in hyps for u in h.split())):
            fail(f"cli.interactive NAR on .npy lines: rc {rc}, {out.getvalue()[-300:]}")
        rows.append(f"cli.interactive (NAR, 2 lines of 480 frames, bf16) {wall:.2f} s, "
                    f"{[len(h.split()) for _, h in hyps]} units")
    print(f"cli.train without data on disk (bf16, the archs' widths, depth {RT_DEPTH} where "
          f"checkpoints are written): " + "; ".join(rows) + f"; {smi}")
    return total


def run_speech_norm_runtime(torch, mods, smi):
    """Phase 29 (module docstring). Returns the CLI runs' launches by JSON
    row."""
    t0 = time.perf_counter()
    run_speech_norm_cli(torch, smi)
    run_lightconv(torch, smi)
    run_alignment(torch, smi)
    launches = run_runtime_cli(torch, smi)
    print(f"phase speech norm / runtime: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches}; {smi}")
    return launches


# Phase 30: data parallelism (module docstring). Two ranks share the one
# card over gloo (NCCL takes one rank a device), each collective on CUDA
# tensors staged through host memory by the port (parallel/mesh.py); one
# rank over NCCL runs the same code in the script's own process.
DP_WORLD = 2
DP_RANK_TIMEOUT_S = 300  # each rank's gloo timeout and the phase's wait for the ranks
DP_TRAIN_B = 33  # (b)'s rows: 17 + 16 over the two ranks
DP_TRAIN = dict(optimizer="sgd", options={"momentum": 0.9}, lr=1e-2, lr_scheduler="fixed",
                clip_norm=2.0, seed=42)
DP_MODES = {"replicated": {}, "--zero-sharding os": {"zero_sharding": "os"},
            "--fsdp": {"fsdp": True}}
# (b)'s bounds against the one-process run, in float32, stated in PERF.md
# before the run that tested them: the first update's loss, and the update
# the two updates made to the masters (relative L2 over the trainable
# masters); a rank's weight gradients sum its own rows, so the sums split
# where the one process's do not. (b) runs in float32: in bf16 that rounding
# moves the random-init normalizer's gradient by tens of percent (PERF.md,
# PR 26: 0.245 of the update against a first loss within 1.7e-4; phase 8's
# kernels against plain versions, the same kind of rounding, give 4.5e-3 in
# the gradient norm). (d)'s cli.train trains in bf16
DP_LOSS_REL, DP_UPDATE_REL = 1e-5, 1e-3
# bf16 forwards: (d)'s 2-rank validation loss against cli.validate at one
# rank, and the one-rank NCCL update's loss against the run without a group
DP_VALID_REL = DP_NCCL_LOSS_REL = 2e-3
DP_SYNTH_UTTS, DP_SYNTH_BATCH = 7, 3  # (e): batches of 3, 3 and 1 rows, padded to 4, 4, 2
DP_ONE_RANK_B = 8  # the one-rank NCCL group's DDIM and update rows


def dp_flat(torch, model, names):
    """The parameters `names` of `model`, flat in float32."""
    params = dict(model.named_parameters())
    return torch.cat([params[n].detach().float().reshape(-1) for n in names])


def dp_ddim(torch, mesh, launches):
    """(a) at full width: DDIM B64 x T128, START_STEP - 1 steps, bf16, its rows
    split over the ranks, against the one-process run (rank 0)."""
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops import _build

    torch.manual_seed(0)
    with torch.device("cuda"):
        model = LatentDiffusionModule()
    model = model.to(torch.bfloat16).eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    feature = torch.randn(B, T, 768, generator=g, device="cuda")
    mask = torch.ones(B, T, dtype=torch.bool, device="cuda")
    enc, init = (torch.randn(B, T, 128, generator=g, device="cuda") for _ in range(2))

    def run(m, stride=1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ddim_sample(model, feature, mask, start_step=START_STEP, stride=stride,
                          enc_noise=enc, init_noise=init, device="cuda", mesh=m)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    run(mesh, stride=START_STEP)  # warm-up: one denoiser call
    mesh.barrier()
    _build.launch_counts.clear()
    (units, recon), wall = run(mesh)
    counted = dict(_build.launch_counts)
    for k, v in counted.items():
        launches[k] = launches.get(k, 0) + v
    out = {"wall": wall, "launches": counted}
    if mesh.index == 0:
        (ref, ref_recon), out["wall_one"] = run(None)
        out["units_differ"] = int((units != ref).sum().item())
        out["recon_max_abs"] = (recon.float() - ref_recon.float()).abs().max().item()
        out["shape"] = list(units.shape)
    mesh.barrier()
    return out


def dp_updates(torch, mesh, launches):
    """(b) at full width: two float32 normalizer updates (dropout 0, draws
    made by the trainer) on B33 x T128, replicated, with --zero-sharding os
    and with --fsdp, against the one-process run (rank 0): losses, gradient
    norms, the masters' update, ms and peak memory per rank."""
    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    micros = [{k: v for k, v in batch.items() if not k.startswith("inject_")}
              for batch in train_batches(torch, 2, 80, "ddpm", b=DP_TRAIN_B)]
    def run(extra, m):
        torch.manual_seed(11)
        with torch.device("cuda"):
            model = LatentDiffusionModule(dropout=0.0)
        names = [n for n, _ in model.named_parameters() if not n.startswith("vae.")]
        start = dp_flat(torch, model, names).cpu()
        trainer = Trainer(TrainerConfig(**DP_TRAIN, **extra), model, DDPMDiscreteLoss(),
                          ("vae",), mesh=m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        _build.launch_counts.clear()
        for batch in micros:
            t1 = time.perf_counter()
            mets = trainer.train_step([batch])
            torch.cuda.synchronize()
            rows.append((mets["loss"], mets["gnorm"], 1e3 * (time.perf_counter() - t1)))
        peak = torch.cuda.max_memory_allocated() / 1e9
        counted = dict(_build.launch_counts)
        with trainer.gathered_master() as master:
            delta = dp_flat(torch, master, names).cpu() - start
        del trainer, model
        torch.cuda.empty_cache()
        return rows, peak, delta, counted

    out, ref = {}, None
    if mesh.index == 0:
        rows, peak, ref, _ = run({}, None)
        out["one process"] = {"rows": rows, "peak_gb": peak}
    mesh.barrier()
    for mode, extra in DP_MODES.items():
        rows, peak, delta, counted = run(extra, mesh)
        for k, v in counted.items():
            launches[k] = launches.get(k, 0) + v
        out[mode] = {"rows": rows, "peak_gb": peak, "launches": counted}
        if ref is not None:
            out[mode]["update_rel"] = ((delta - ref).norm() / ref.norm()).item()
        mesh.barrier()
    return out


def dp_s2st(torch, mesh, launches):
    """(c): the long-form S2ST chain (B2 x 8448 frames) in float32 with its
    rows split over the ranks, against the one-process run (rank 0)."""
    from diffnorm_tpu_torch.generate.s2st import s2st_generate
    from diffnorm_tpu_torch.models.hifigan import CodeHiFiGANVocoder
    from diffnorm_tpu_torch.ops import _build

    nar = seeded_nar(torch, 0, dtype=torch.float32)
    voc = CodeHiFiGANVocoder.from_config(VOCODER_CFG, device="cuda",
                                         dtype=torch.float32).module
    src, lengths = s2st_inputs(torch, LONG_B, LONG_FRAMES)

    def run(m):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = s2st_generate(nar, voc, src, lengths, mesh=m, **S2ST_KW)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t1

    run(mesh)  # warm-up
    mesh.barrier()
    _build.launch_counts.clear()
    (wav, _, units, counts, steps), wall = run(mesh)
    # float32: the launches of the kernel's float32 row
    counted = {("flash_attention_f32" if k == "flash_attention" else k): v
               for k, v in _build.launch_counts.items()}
    for k, v in counted.items():
        launches[k] = launches.get(k, 0) + v
    out = {"wall": wall, "launches": counted, "steps": steps.tolist(), "counts": counts.tolist()}
    if mesh.index == 0:
        (wav_ref, _, units_ref, counts_ref, _), out["wall_one"] = run(None)
        out["units_equal"] = bool(torch.equal(units, units_ref)
                                  and torch.equal(counts, counts_ref))
        out["wav_row_cos"] = torch.nn.functional.cosine_similarity(
            wav.float(), wav_ref.float(), dim=-1).min().item()
        out["finite"] = bool(torch.isfinite(wav.float()).all())
    mesh.barrier()
    return out


def dp_cli(torch, mesh, root: Path):
    """(d) cli.train of the normalizer at CLI_NORMALIZER's depth at two ranks
    with --fsdp --zero-sharding os; (e) cli.diff_norm_synthesis
    --data-parallel 2 on its checkpoint."""
    from diffnorm_tpu_torch.cli import diff_norm_synthesis
    from diffnorm_tpu_torch.cli import train as train_cli

    t1 = time.perf_counter()
    rc = train_cli.main(json.loads((root / "train_argv.json").read_text()))
    train_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    rc_synth = diff_norm_synthesis.main(json.loads((root / "synth_argv.json").read_text())
                                        + ["--output-dir", str(root / "synth_dp"),
                                           "--data-parallel", str(DP_WORLD)])
    return {"train_rc": rc, "train_s": train_s, "synth_rc": rc_synth,
            "synth_s": time.perf_counter() - t1}


def dp_worker() -> int:
    """One rank of phase 30 (run_data_parallel starts them): joins the gloo
    group of the environment on cuda:0, runs (a)-(e)'s data-parallel halves
    (rank 0 also the one-process runs of (a)-(c)) and writes its results to
    DP_ROOT/rank{R}.json."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    root = Path(os.environ["DP_ROOT"])
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT_S))
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.parallel.mesh import make_mesh

    _build.build(["rms_norm_film", "wavenet_chain", "flash_attention"])  # built: loads
    mesh = make_mesh()
    launches, out, t0 = {}, {}, time.perf_counter()
    for what, fn in (("ddim", lambda: dp_ddim(torch, mesh, launches)),
                     ("updates", lambda: dp_updates(torch, mesh, launches)),
                     ("s2st", lambda: dp_s2st(torch, mesh, launches)),
                     ("cli", lambda: dp_cli(torch, mesh, root))):
        t1 = time.perf_counter()
        out[what] = fn()
        out[what]["phase_s"] = time.perf_counter() - t1
    out["launches"], out["wall_s"] = launches, time.perf_counter() - t0
    (root / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def dp_one_rank_nccl(torch, smi):
    """A process group of one rank over NCCL in this process: the same
    data-parallel code with NCCL's collectives (a DDIM and a normalizer
    update at CLI_NORMALIZER's depth, B8 x T128, against the run without a
    group; the collectives' shapes on their own). Returns its launches."""
    import socket

    import torch.distributed as dist

    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.parallel.mesh import make_mesh
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh()
        if mesh.backend != "nccl":
            fail(f"one-rank group: backend {mesh.backend}")
        x = torch.arange(24.0, device="cuda").reshape(2, 3, 4)
        for got, what in ((mesh.all_reduce(x.clone()), "all_reduce"),
                          (mesh.all_gather(x, dim=1), "all_gather"),
                          (mesh.reduce_scatter(x, dim=2), "reduce_scatter"),
                          (mesh.broadcast(x.clone()), "broadcast"),
                          (mesh.all_gather_rows(x, 2), "all_gather_rows")):
            if not torch.equal(got, x):
                fail(f"one-rank NCCL {what} changed its tensor")
        torch.manual_seed(0)
        with torch.device("cuda"):
            model = LatentDiffusionModule(**CLI_NORMALIZER)
        model = model.to(torch.bfloat16).eval()
        g = torch.Generator(device="cuda").manual_seed(1)
        b = DP_ONE_RANK_B
        feature = torch.randn(b, T, 768, generator=g, device="cuda")
        mask = torch.ones(b, T, dtype=torch.bool, device="cuda")
        launches = {}
        runs = []
        for m in (mesh, None):
            _build.launch_counts.clear()
            runs.append(ddim_sample(model, feature, mask, start_step=START_STEP, device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(5),
                                    mesh=m))
            if m is not None:
                launches = dict(_build.launch_counts)
        if not torch.equal(runs[0][0], runs[1][0]):
            fail("one-rank NCCL ddim_sample: units differ from the run without a group")
        del model
        losses = []
        for m in (mesh, None):
            torch.manual_seed(11)
            with torch.device("cuda"):
                model = LatentDiffusionModule(dropout=0.0, **CLI_NORMALIZER)
            trainer = Trainer(TrainerConfig(**DP_TRAIN, dtype="bfloat16", zero_sharding="os"),
                              model, DDPMDiscreteLoss(), ("vae",), mesh=m)
            batch = {k: v for k, v in train_batches(torch, 1, 81, "ddpm", b=b)[0].items()
                     if not k.startswith("inject_")}
            _build.launch_counts.clear()
            losses.append(trainer.train_step([batch])["loss"])
            if m is not None:
                for k, v in _build.launch_counts.items():
                    launches[k] = launches.get(k, 0) + v
            del trainer, model
        if abs(losses[0] - losses[1]) > DP_NCCL_LOSS_REL * abs(losses[1]):
            fail(f"one-rank NCCL update: loss {losses[0]} against {losses[1]} without a group")
    finally:
        dist.destroy_process_group()
    print(f"data parallel, one rank over NCCL (collectives on CUDA tensors; DDIM B{b}xT{T} and "
          f"a normalizer update at depth {CLI_NORMALIZER}): units equal to the run without a "
          f"group, update loss {losses[0]:.6f} against {losses[1]:.6f}, launches {launches}, "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    return launches


def dp_write_inputs(root: Path):
    """cli.train's corpus and argv for (d), a synthesis corpus and argv for (e)."""
    import numpy as np

    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    feat_dir = write_train_corpus(root)
    train_argv = [str(root), "--tgt-feat-dir", str(feat_dir), "--task",
                  "speech_diffusion_discrete", "--target-code-size", "1000", "--latent-dim",
                  "128", "--lr", "1e-4", "--warmup-updates", "10000", "--warmup-init-lr",
                  "1e-7", "--clip-norm", "2.0", "--max-tokens", "1200", "--seed", "42",
                  "--log-interval", "1", "--dtype", "bfloat16", "--max-update", "2",
                  "--save-dir", str(root / "ckpt"), "--data-parallel", str(DP_WORLD), "--fsdp",
                  "--zero-sharding", "os", *normalizer_flags(CLI_NORMALIZER)]
    (root / "train_argv.json").write_text(json.dumps(train_argv))
    rng = np.random.default_rng(30)
    synth = root / "synth"
    (synth / "feat").mkdir(parents=True)
    rows, lines = [], [str(synth / "feat")]
    for i in range(DP_SYNTH_UTTS):
        units = rng.integers(0, 1000, size=int(rng.integers(40, 129)))
        units[1::4] = units[::4][:len(units[1::4])]  # runs to reduce
        np.save(synth / "feat" / f"s{i}.npy",
                rng.normal(size=(len(units), 768)).astype(np.float32))
        lines.append(f"s{i}.npy\t{len(units)}")
        rows.append({"id": f"s{i}", "src_audio": f"s{i}.wav", "src_n_frames": len(units),
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
    (synth / "feat" / "test.manifest.tsv").write_text("\n".join(lines) + "\n")
    write_translation_manifest(str(synth / "test.tsv"), rows)
    synth_argv = [str(synth), "--params-npz", str(root / "ckpt" / "step_000000002"),
                  "--tgt-feat-dir", str(synth / "feat"), "--splits", "test", "--batch-size",
                  str(DP_SYNTH_BATCH), *normalizer_flags(CLI_NORMALIZER)]
    (root / "synth_argv.json").write_text(json.dumps(synth_argv))
    return train_argv, synth_argv


def dp_spawn(root: Path, worker: str = "dp_worker", what: str = "data parallel"):
    """DP_WORLD ranks of `worker` on the card; each rank's results. Every
    rank is killed when one fails or the ranks outlive DP_RANK_TIMEOUT_S."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent
    code = (f"import sys; sys.path.insert(0, {str(repo)!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.{worker}())")
    procs = []
    for rank in range(DP_WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(DP_WORLD),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), DP_ROOT=str(root))
        log = open(root / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, cwd=repo,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    t0, bad = time.perf_counter(), None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = next((r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)), None)
            if bad is not None or time.perf_counter() - t0 > DP_RANK_TIMEOUT_S:
                break
            time.sleep(0.2)
        bad = next((r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)), bad)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if bad is not None or any(not (root / f"rank{r}.json").exists() for r in range(DP_WORLD)):
        r = bad or 0
        tail = (root / f"rank{r}.log").read_text()[-3000:]
        fail(f"{what}: rank {r} failed or timed out after "
             f"{time.perf_counter() - t0:.0f} s:\n{tail}")
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(DP_WORLD)], \
        time.perf_counter() - t0


def run_data_parallel(torch, mods, smi):
    """Phase 30 (module docstring). Returns its launches by JSON row: the
    ranks' data-parallel runs and the one-rank NCCL group's."""
    from diffnorm_tpu_torch.cli import diff_norm_synthesis, validate

    t0 = time.perf_counter()
    launches = dp_one_rank_nccl(torch, smi)
    torch.cuda.empty_cache()  # the card's memory to the ranks' processes
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        train_argv, synth_argv = dp_write_inputs(root)
        ranks, spawn_s = dp_spawn(root)
        r0 = ranks[0]
        for res in ranks:
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
        # (a)
        a = r0["ddim"]
        if a["units_differ"] or a["shape"] != [B, T]:
            fail(f"data-parallel DDIM: {a['units_differ']} of {B * T} units differ from the "
                 f"one-process run")
        print(f"data parallel (a) DDIM B{B}xT{T}, {START_STEP - 1} steps, bf16, rows split "
              f"over {DP_WORLD} ranks on one card (gloo): units equal to the one-process run, "
              f"recon max-abs {a['recon_max_abs']:.3e}; wall {a['wall']:.4f} s (rank 1 "
              f"{ranks[1]['ddim']['wall']:.4f} s) against {a['wall_one']:.4f} s in one process; "
              f"launches rank 0 {a['launches']}, rank 1 {ranks[1]['ddim']['launches']}; {smi}")
        # (b)
        u = r0["updates"]
        one = u["one process"]
        ref = one["rows"]
        for mode in DP_MODES:
            rows = u[mode]["rows"]
            loss_rel = abs(rows[0][0] - ref[0][0]) / abs(ref[0][0])
            if loss_rel > DP_LOSS_REL or u[mode]["update_rel"] > DP_UPDATE_REL:
                fail(f"data-parallel update {mode}: first loss rel {loss_rel:.3e} (bound "
                     f"{DP_LOSS_REL}), masters' update rel {u[mode]['update_rel']:.3e} "
                     f"(bound {DP_UPDATE_REL})")
            print(f"data parallel (b) normalizer updates {mode}, float32, B{DP_TRAIN_B}xT{T} "
                  f"over {DP_WORLD} ranks (17 + 16 rows), sgd momentum 0.9: losses "
                  f"{[round(r[0], 6) for r in rows]} against {[round(r[0], 6) for r in ref]} "
                  f"(first rel {loss_rel:.2e}), gnorms {[round(r[1], 5) for r in rows]} against "
                  f"{[round(r[1], 5) for r in ref]}, masters' update rel "
                  f"{u[mode]['update_rel']:.2e}; ms per update {[round(r[2], 1) for r in rows]} "
                  f"(rank 1 {[round(r[2], 1) for r in ranks[1]['updates'][mode]['rows']]}; one "
                  f"process {[round(r[2], 1) for r in ref]}); peak per rank "
                  f"{u[mode]['peak_gb']:.2f} / {ranks[1]['updates'][mode]['peak_gb']:.2f} GB "
                  f"(one process {one['peak_gb']:.2f} GB); {smi}")
        # (c)
        c = r0["s2st"]
        if not (c["units_equal"] and c["finite"]) or c["wav_row_cos"] < LONG_WAV_ROW_COS:
            fail(f"data-parallel long-form S2ST: units equal {c['units_equal']}, waveform "
                 f"row-cos {c['wav_row_cos']:.6f} (bound {LONG_WAV_ROW_COS})")
        n_flash = [res["s2st"]["launches"].get("flash_attention_f32", 0) for res in ranks]
        if not all(n_flash):
            fail(f"data-parallel long-form S2ST launched flash_attention_f32 {n_flash} times")
        print(f"data parallel (c) long-form S2ST B{LONG_B}x{LONG_FRAMES} frames, float32, one "
              f"row a rank: units equal to the one-process run, waveform row-cos min "
              f"{c['wav_row_cos']:.6f}; iterations {c['steps']}; wall {c['wall']:.4f} s "
              f"against {c['wall_one']:.4f} s in one process; flash_attention_f32 launches "
              f"{n_flash} by rank; {smi}")
        # (d)
        d = r0["cli"]
        if d["train_rc"] or d["synth_rc"] or ranks[1]["cli"]["train_rc"]:
            fail(f"data-parallel CLIs: rc {d}, rank 1 {ranks[1]['cli']}")
        manifest = json.loads((root / "ckpt" / "manifest.json").read_text())
        loss2 = next(e["metric"] for e in manifest["checkpoints"] if e["step"] == 2)
        t1 = time.perf_counter()
        keep = [a for a in train_argv if a not in ("--fsdp",)]
        for flag in ("--data-parallel", "--zero-sharding", "--lr", "--warmup-updates",
                     "--warmup-init-lr", "--clip-norm", "--log-interval", "--max-update",
                     "--save-dir"):
            i = keep.index(flag)
            del keep[i:i + 2]
        vals = validate.validate(validate.parse_args(
            keep + ["--path", str(root / "ckpt" / "step_000000002")]))
        valid_s = time.perf_counter() - t1
        rel = abs(vals["loss"] - loss2) / abs(loss2)
        if rel > DP_VALID_REL:
            fail(f"cli.validate at one rank: loss {vals['loss']} against the 2-rank run's "
                 f"{loss2} (rel {rel:.3e}, bound {DP_VALID_REL})")
        print(f"data parallel (d) cli.train normalizer at {DP_WORLD} ranks --fsdp "
              f"--zero-sharding os (depth {CLI_NORMALIZER}, bf16, 2 updates, 24 utterances): "
              f"{d['train_s']:.2f} s; its validation loss {loss2:.6f}, cli.validate at one rank "
              f"on its checkpoint {vals['loss']:.6f} (rel {rel:.2e}, {valid_s:.2f} s); {smi}")
        # (e)
        t1 = time.perf_counter()
        rc = diff_norm_synthesis.main(synth_argv + ["--output-dir", str(root / "synth_one")])
        one = (root / "synth_one" / "test.tsv").read_bytes() if rc == 0 else b""
        dp = (root / "synth_dp" / "test.tsv").read_bytes()
        if len(one.splitlines()) != DP_SYNTH_UTTS + 1 or dp != one:
            fail(f"cli.diff_norm_synthesis --data-parallel {DP_WORLD}: its test.tsv differs "
                 f"from the one-process run's ({len(dp.splitlines())} and "
                 f"{len(one.splitlines())} lines)")
        print(f"data parallel (e) cli.diff_norm_synthesis --data-parallel {DP_WORLD} "
              f"({DP_SYNTH_UTTS} utterances, batches of {DP_SYNTH_BATCH}, padded rows): "
              f"test.tsv byte for byte the one-process run's; {d['synth_s']:.2f} s at "
              f"{DP_WORLD} ranks, {time.perf_counter() - t1:.2f} s in one process; {smi}")
        print(f"phase data parallel: {time.perf_counter() - t0:.1f} s (the ranks "
              f"{spawn_s:.1f} s, rank 0's parts "
              f"{ {k: round(r0[k]['phase_s'], 1) for k in ('ddim', 'updates', 's2st', 'cli')} }), "
              f"launches {launches}; {smi}")
    return launches


MP_B = 16  # (a) and (d)'s rows
MP_LOSS_REL, MP_UPDATE_REL = DP_LOSS_REL, DP_UPDATE_REL  # (a): phase 30's bounds
MP_SCORE_ATOL = 1e-4  # (b): tests/test_multichip_inference.py:119-121
MP_ROW_COS = 0.99999  # (c), (d)
MP_STAGE_LAYERS, MP_MICRO = 6, 4  # (d): 6 layers a stage, 4 microbatches
MP_VALID_REL = DP_VALID_REL  # (e): bf16 forwards


def mp_peak(torch, fn):
    """fn()'s result, wall seconds and this process's peak memory (GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t1, torch.cuda.max_memory_allocated() / 1e9


def mp_counted(torch, fn, launches, f32=False):
    """fn() with the kernels' launches counted and added to `launches` (a
    float32 flash_attention's under flash_attention_f32)."""
    from diffnorm_tpu_torch.ops import _build

    _build.launch_counts.clear()
    out = fn()
    counted = {("flash_attention_f32" if f32 and k == "flash_attention" else k): v
               for k, v in _build.launch_counts.items()}
    for k, v in counted.items():
        launches[k] = launches.get(k, 0) + v
    return out, counted


def mp_updates(torch, mesh, launches):
    """(a): two float32 normalizer updates at tensor parallel 2 on B16 x
    T128, and in one process (rank 0)."""
    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    micros = [{k: v for k, v in batch.items() if not k.startswith("inject_")}
              for batch in train_batches(torch, 2, 80, "ddpm", b=MP_B)]

    def run(m, launches):
        torch.manual_seed(11)
        with torch.device("cuda"):
            model = LatentDiffusionModule(dropout=0.0)
        names = [n for n, _ in model.named_parameters() if not n.startswith("vae.")]
        start = dp_flat(torch, model, names).cpu()
        trainer = Trainer(TrainerConfig(**DP_TRAIN), model, DDPMDiscreteLoss(), ("vae",),
                          mesh=m)
        rows, counted = [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for batch in micros:
            t1 = time.perf_counter()
            mets, c = mp_counted(torch, lambda: trainer.train_step([batch]), launches)
            torch.cuda.synchronize()
            rows.append((mets["loss"], mets["gnorm"], 1e3 * (time.perf_counter() - t1)))
            for k, v in c.items():
                counted[k] = counted.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 1e9
        with trainer.gathered_master() as master:
            delta = dp_flat(torch, master, names).cpu() - start
        del trainer, model
        torch.cuda.empty_cache()
        return rows, peak, delta, counted

    rows, peak, delta, counted = run(mesh, launches)
    out = {"rows": rows, "peak_gb": peak, "launches": counted}
    mesh.barrier()
    if mesh.rank == 0:  # the reference's launches are not the parallel run's
        one = {}
        one["rows"], one["peak_gb"], ref, _ = run(None, {})
        out["one"] = one
        out["update_rel"] = ((delta - ref).norm() / ref.norm()).item()
    mesh.barrier()
    return out


def mp_decode_and_sp(torch, mesh, launches):
    """(b) the long-form float32 decode with the NAR model split over the
    model group, and in one process (rank 0); (c) its encoder run
    sequence-parallel over the 2 ranks, and unsharded (rank 0)."""
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.parallel.mesh import make_seq_mesh
    from diffnorm_tpu_torch.parallel.sequence import conformer_encode_sp
    from diffnorm_tpu_torch.parallel.sharding_rules import shard_model

    one = seeded_nar(torch, 0, dtype=torch.float32)
    split = seeded_nar(torch, 0, dtype=torch.float32)
    shard_model(split, mesh.model_axis)
    src, lengths = s2st_inputs(torch, LONG_B, LONG_FRAMES)
    kw = dict(max_iter=S2ST_KW["max_iter"], max_len=S2ST_KW["max_len"])
    out = {}
    with torch.no_grad():
        mask_predict_decode(split, src, lengths, mesh=mesh, **kw)  # warm-up
        ((tokens, scores, steps), counted), wall, peak = mp_peak(torch, lambda: mp_counted(
            torch, lambda: mask_predict_decode(split, src, lengths, mesh=mesh, **kw), launches,
            f32=True))
        out["decode"] = {"wall": wall, "peak_gb": peak, "launches": counted,
                         "steps": steps.tolist()}
        seq = make_seq_mesh(2)
        conformer_encode_sp(one.encoder, src, lengths, seq)  # warm-up
        (sp_out, sp_mask), wall, peak = mp_peak(
            torch, lambda: conformer_encode_sp(one.encoder, src, lengths, seq))
        out["sp"] = {"wall": wall, "peak_gb": peak, "frames": int(sp_mask.shape[1])}
        mesh.barrier()
        if mesh.rank == 0:
            (ref_tokens, ref_scores, _), out["decode"]["wall_one"], out["decode"]["peak_one"] = \
                mp_peak(torch, lambda: mask_predict_decode(one, src, lengths, **kw))
            out["decode"]["tokens_equal"] = bool(torch.equal(tokens, ref_tokens))
            out["decode"]["score_max_abs"] = (scores - ref_scores).abs().max().item()
            out["decode"]["varied"] = int((tokens >= 4).sum().item())
            (ref, ref_mask), out["sp"]["wall_one"], out["sp"]["peak_one"] = mp_peak(
                torch, lambda: one.encoder(src, lengths))
            valid = ref_mask.reshape(-1)
            cos = torch.nn.functional.cosine_similarity(
                sp_out.reshape(-1, sp_out.shape[-1])[valid], ref.reshape(-1, ref.shape[-1])[valid],
                dim=-1)
            out["sp"]["row_cos"] = cos.min().item()
            out["sp"]["max_abs"] = ((sp_out - ref) * ref_mask[..., None]).abs().max().item()
            out["sp"]["mask_equal"] = bool(torch.equal(sp_mask, ref_mask))
        mesh.barrier()
    del one, split
    torch.cuda.empty_cache()
    return out


def mp_stage_layers(tr, h, idx, cond, mask):
    """Layers `idx` of a ConditionableTransformer on h (the body of its
    forward, a FiLM norm per sublayer)."""
    for i in idx:
        h = h + tr.layer("attn", i)(tr.layer("attn_norm", i)(h, cond=cond), mask=mask)
        h = h + tr.layer("ff", i)(tr.layer("ff_norm", i)(h, cond=cond))
    return h


def mp_pipeline(torch, mesh, launches):
    """(d): the normalizer transformer's 12 layers as 2 pipeline stages of 6,
    4 microbatches of B16 x T128, float32, and in one process (rank 0)."""
    from diffnorm_tpu_torch.models.layers import ConditionableTransformer
    from diffnorm_tpu_torch.parallel.mesh import make_stage_mesh
    from diffnorm_tpu_torch.parallel.pipeline import pipeline_apply

    torch.manual_seed(12)
    with torch.device("cuda"):
        tr = ConditionableTransformer(512, 12, dim_head=64, heads=8, ff_mult=4,
                                      ff_causal_conv=True, cond_dim=2048).eval()
    g = torch.Generator(device="cuda").manual_seed(13)
    micro = torch.randn(MP_MICRO, MP_B, T, 512, generator=g, device="cuda")
    cond = torch.randn(MP_B, 2048, generator=g, device="cuda")
    mask = torch.ones(MP_B, T, dtype=torch.bool, device="cuda")
    stages = make_stage_mesh(2)
    mine = range(stages.index * MP_STAGE_LAYERS, (stages.index + 1) * MP_STAGE_LAYERS)
    out = {}
    with torch.no_grad():
        (got, counted), wall, peak = mp_peak(torch, lambda: mp_counted(torch, lambda: (
            pipeline_apply(lambda idx, h: mp_stage_layers(tr, h, idx, cond, mask), mine, micro,
                           stages)), launches))
        out.update(wall=wall, peak_gb=peak, launches=counted)
        mesh.barrier()
        if mesh.rank == 0:
            ref, out["wall_one"], out["peak_one"] = mp_peak(torch, lambda: torch.stack([
                mp_stage_layers(tr, x, range(12), cond, mask) for x in micro]))
            out["row_cos"] = torch.nn.functional.cosine_similarity(
                got.reshape(-1, 512), ref.reshape(-1, 512), dim=-1).min().item()
            out["max_abs"] = (got - ref).abs().max().item()
        mesh.barrier()
    del tr
    torch.cuda.empty_cache()
    return out


def mp_worker() -> int:
    """One rank of phase 31 (run_model_parallel starts them): joins the gloo
    group of the environment on cuda:0, runs (a)-(e)'s parallel halves
    (rank 0 also the one-process runs) and writes its results to
    DP_ROOT/rank{R}.json."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    root = Path(os.environ["DP_ROOT"])
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT_S))
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.ops import _build
    from diffnorm_tpu_torch.parallel.mesh import make_mesh

    _build.build(["rms_norm_film", "wavenet_chain", "flash_attention"])  # built: loads
    mesh = make_mesh(1, world)
    launches, out, t0 = {}, {}, time.perf_counter()
    for what, fn in (("updates", lambda: mp_updates(torch, mesh, launches)),
                     ("decode_sp", lambda: mp_decode_and_sp(torch, mesh, launches)),
                     ("pipeline", lambda: mp_pipeline(torch, mesh, launches))):
        t1 = time.perf_counter()
        out[what] = fn()
        out[what]["phase_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    rc, counted = mp_counted(
        torch, lambda: train_cli.main(json.loads((root / "train_argv.json").read_text())),
        launches)
    out["cli"] = {"train_rc": rc, "train_s": time.perf_counter() - t1, "launches": counted,
                  "phase_s": time.perf_counter() - t1}
    out["launches"], out["wall_s"] = launches, time.perf_counter() - t0
    (root / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def mp_hold_kernels(torch, mods):
    """rms_norm_film, wavenet_chain and flash_attention_f32 against their
    plain versions at the shapes a rank ran: the normalizer's norms and
    WaveNets at B16 x T128 (float32; the WaveNets whole on each rank), and
    the decoder's encoder attention with 4 of the 8 heads (float32, q
    [2,4,256,64], k/v [2,4,2112,64], keys 2112 and 1056)."""
    norm, chain, _, _, flash = mods
    check_rms_norm_film(torch, norm, b=MP_B, t=T)
    cases = [("denoiser", 512, 4, d) for d in (1, 2, 4, 8, 16, 32, 64, 128)] + [
        ("vae encoder", 256, 2, 4), ("vae decoder", 768, 2, 1)]
    worst, timed = 0.0, None
    for n, (what, c, s, d) in enumerate(cases):
        inp = chain_inputs(torch, c, s, 3, seed=90 + n, b=MP_B, t=T, dtype=torch.float32)
        got = chain.wavenet_chain(**inp, dilation=d)
        ref = chain.wavenet_chain_plain(**inp, dilation=d)
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        if not torch.isfinite(got).all() or rel > CHAIN_F32_REL_ERR:
            fail(f"wavenet_chain {what} [{MP_B},{T},{c}] S={s} d={d} float32: max-abs/scale "
                 f"{rel:.3e}")
        worst = max(worst, rel)
        if timed is None:  # the denoiser's first chain, timed
            ms = cuda_time_ms(lambda: chain.wavenet_chain(**inp, dilation=d))
            plain_ms = cuda_time_ms(lambda: chain.wavenet_chain_plain(**inp, dilation=d),
                                    iters=3, reps=3)
            bound_ms, by = bound(*chain_work(c, s, 3, d, inp), F32_FLOP_PER_S)
            timed = f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})"
    print(f"kernel wavenet_chain at a rank's shapes [{MP_B},{T},C] float32 (the denoiser's 8 "
          f"dilations at C 512, the VAE's encoder and decoder chains): every case within "
          f"max-abs/scale {worst:.2e} (bound {CHAIN_F32_REL_ERR}); the denoiser's d=1 chain "
          f"{timed}")
    g = torch.Generator(device="cuda").manual_seed(91)
    q, k, v = (torch.randn(LONG_B, 4, t, 64, generator=g, device="cuda")
               for t in (256, 2112, 2112))
    mask = (torch.arange(2112, device="cuda")[None, :]
            < torch.tensor([2112, 1056], device="cuda")[:, None])
    got = flash.flash_attention(q, k, v, mask)
    ref = flash.flash_attention_plain(q, k, v, mask)
    err = (got - ref).abs()
    if not torch.isfinite(got).all() or (err > FLASH_ATOL + FLASH_RTOL * ref.abs()).any():
        fail(f"flash_attention float32 at [2,4,256,64] k/v [2,4,2112,64]: max err "
             f"{err.max().item():.3e}")
    ms = cuda_time_ms(lambda: flash.flash_attention(q, k, v, mask))
    plain_ms = cuda_time_ms(lambda: flash.flash_attention_plain(q, k, v, mask), iters=3, reps=3)
    library_ms = cuda_time_eager_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]))
    keys = 2112 + 1056  # the valid keys' work, as check_flash_attention bounds it
    nbytes = (2 * q.numel() + 2 * 4 * keys * 64) * 4 + mask.numel()
    flops = 4.0 * 4 * 256 * keys * 64
    bound_ms, by = min(bound(nbytes, flops, F32_FLOP_PER_S),
                       bound(nbytes, 3 * flops, TF32_FLOP_PER_S))
    print(f"kernel flash_attention float32 at a model rank's decoder attention (q [2,4,256,64], "
          f"k/v [2,4,2112,64], keys [2112, 1056]): {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}), F.scaled_dot_product_attention with the mask "
          f"{library_ms:.4f} ms, max err {err.max().item():.3e}, within rtol {FLASH_RTOL} "
          f"atol {FLASH_ATOL}")


def run_model_parallel(torch, mods, smi):
    """Phase 31 (module docstring). Returns the ranks' launches."""
    from diffnorm_tpu_torch.cli import validate

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the card's memory to the ranks' processes
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        train_argv, _ = dp_write_inputs(root)
        for flag in ("--data-parallel", "--fsdp", "--zero-sharding"):
            i = train_argv.index(flag)
            del train_argv[i:i + (1 if flag == "--fsdp" else 2)]
        train_argv += ["--model-parallel", "2", "--data-parallel", "1", "--profile",
                       "--heartbeat-timeout", "600"]
        (root / "train_argv.json").write_text(json.dumps(train_argv))
        ranks, spawn_s = dp_spawn(root, "mp_worker", "model parallel")
        r0, r1 = ranks
        for res in ranks:
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
        # (a)
        u, u1 = r0["updates"], r1["updates"]
        rows, ref = u["rows"], u["one"]["rows"]
        loss_rel = abs(rows[0][0] - ref[0][0]) / abs(ref[0][0])
        if loss_rel > MP_LOSS_REL or u["update_rel"] > MP_UPDATE_REL:
            fail(f"tensor-parallel update: first loss rel {loss_rel:.3e} (bound {MP_LOSS_REL}), "
                 f"masters' update rel {u['update_rel']:.3e} (bound {MP_UPDATE_REL})")
        for name in ("rms_norm_film", "wavenet_chain"):
            if not (u["launches"].get(name) and u1["launches"].get(name)):
                fail(f"tensor-parallel update launched {name} {u['launches'].get(name)} / "
                     f"{u1['launches'].get(name)} times")
        print(f"model parallel (a) normalizer updates at tensor parallel 2 (released widths, "
              f"float32, B{MP_B}xT{T}, sgd momentum 0.9, two gloo ranks on one card): losses "
              f"{[round(r[0], 6) for r in rows]} against {[round(r[0], 6) for r in ref]} (first "
              f"rel {loss_rel:.2e}), gnorms {[round(r[1], 5) for r in rows]} against "
              f"{[round(r[1], 5) for r in ref]}, masters' update rel {u['update_rel']:.2e}; ms "
              f"per update {[round(r[2], 1) for r in rows]} (rank 1 "
              f"{[round(r[2], 1) for r in u1['rows']]}; one process "
              f"{[round(r[2], 1) for r in ref]}); peak per rank {u['peak_gb']:.2f} / "
              f"{u1['peak_gb']:.2f} GB (one process {u['one']['peak_gb']:.2f} GB); launches a "
              f"rank {u['launches']} / {u1['launches']}; {smi}")
        # (b)
        dec, dec1 = r0["decode_sp"]["decode"], r1["decode_sp"]["decode"]
        n_flash = [d["launches"].get("flash_attention_f32", 0) for d in (dec, dec1)]
        if (not dec["tokens_equal"] or dec["score_max_abs"] > MP_SCORE_ATOL
                or not all(n_flash) or dec["varied"] < 8):
            fail(f"tensor-parallel long-form decode: tokens equal {dec['tokens_equal']}, score "
                 f"max-abs {dec['score_max_abs']:.3e} (bound {MP_SCORE_ATOL}), "
                 f"flash_attention_f32 launches {n_flash}, {dec['varied']} units")
        print(f"model parallel (b) mask-predict decode B{LONG_B}x{LONG_FRAMES} frames, float32, "
              f"the NAR model at tensor parallel 2 (4 of 8 heads a rank): tokens equal to one "
              f"process ({dec['varied']} units), score max-abs {dec['score_max_abs']:.2e}, "
              f"iterations {dec['steps']}; wall {dec['wall']:.4f} s (rank 1 {dec1['wall']:.4f} s) "
              f"against {dec['wall_one']:.4f} s in one process; peak per rank "
              f"{dec['peak_gb']:.2f} / {dec1['peak_gb']:.2f} GB (one process "
              f"{dec['peak_one']:.2f} GB); flash_attention_f32 launches {n_flash} by rank; {smi}")
        # (c)
        sp, sp1 = r0["decode_sp"]["sp"], r1["decode_sp"]["sp"]
        if not sp["mask_equal"] or sp["row_cos"] < MP_ROW_COS:
            fail(f"sequence-parallel conformer: mask equal {sp['mask_equal']}, row-cos "
                 f"{sp['row_cos']:.7f} (bound {MP_ROW_COS})")
        print(f"model parallel (c) conformer_encode_sp over 2 ranks (the NAR's 12-layer "
              f"512-d encoder, B{LONG_B}x{LONG_FRAMES} frames -> {sp['frames']}, float32): "
              f"valid frames' row-cos min {sp['row_cos']:.7f}, max-abs {sp['max_abs']:.3e} "
              f"against the unsharded encoder; wall {sp['wall']:.4f} s (rank 1 "
              f"{sp1['wall']:.4f} s) against {sp['wall_one']:.4f} s; peak per rank "
              f"{sp['peak_gb']:.2f} / {sp1['peak_gb']:.2f} GB (one process "
              f"{sp['peak_one']:.2f} GB); {smi}")
        # (d)
        pp, pp1 = r0["pipeline"], r1["pipeline"]
        if pp["row_cos"] < MP_ROW_COS:
            fail(f"pipeline: row-cos {pp['row_cos']:.7f} (bound {MP_ROW_COS})")
        print(f"model parallel (d) pipeline_apply, 2 stages of {MP_STAGE_LAYERS} of the "
              f"normalizer transformer's 12 layers, {MP_MICRO} microbatches of B{MP_B}xT{T}, "
              f"float32: row-cos min {pp['row_cos']:.7f}, max-abs {pp['max_abs']:.3e} against "
              f"the 12 layers in one process; wall {pp['wall']:.4f} s (rank 1 {pp1['wall']:.4f} "
              f"s) against {pp['wall_one']:.4f} s; peak per rank {pp['peak_gb']:.2f} / "
              f"{pp1['peak_gb']:.2f} GB (one process {pp['peak_one']:.2f} GB); rms_norm_film "
              f"launches {pp['launches'].get('rms_norm_film')} / "
              f"{pp1['launches'].get('rms_norm_film')}; {smi}")
        # (e)
        cli, cli1 = r0["cli"], r1["cli"]
        trace = root / "ckpt" / "profile" / "trace_rank0.json"
        if cli["train_rc"] or cli1["train_rc"] or not trace.exists() or not trace.stat().st_size:
            fail(f"cli.train --model-parallel 2: rc {cli['train_rc']} / {cli1['train_rc']}, "
                 f"trace {trace.exists() and trace.stat().st_size}")
        manifest = json.loads((root / "ckpt" / "manifest.json").read_text())
        loss2 = next(e["metric"] for e in manifest["checkpoints"] if e["step"] == 2)
        keep = list(train_argv)
        for flag in ("--model-parallel", "--data-parallel", "--lr", "--warmup-updates",
                     "--warmup-init-lr", "--clip-norm", "--log-interval", "--max-update",
                     "--save-dir", "--heartbeat-timeout"):
            i = keep.index(flag)
            del keep[i:i + 2]
        keep.remove("--profile")
        t1 = time.perf_counter()
        vals = validate.validate(validate.parse_args(
            keep + ["--path", str(root / "ckpt" / "step_000000002")]))
        valid_s = time.perf_counter() - t1
        rel = abs(vals["loss"] - loss2) / abs(loss2)
        if rel > MP_VALID_REL:
            fail(f"cli.validate at one rank: loss {vals['loss']} against the TP-2 run's {loss2} "
                 f"(rel {rel:.3e}, bound {MP_VALID_REL})")
        print(f"model parallel (e) cli.train normalizer --model-parallel 2 --profile "
              f"--heartbeat-timeout 600 (depth {CLI_NORMALIZER}, bf16, 2 updates): "
              f"{cli['train_s']:.2f} s, trace {trace.stat().st_size} bytes; its validation loss "
              f"{loss2:.6f}, cli.validate at one rank on its checkpoint {vals['loss']:.6f} (rel "
              f"{rel:.2e}, {valid_s:.2f} s); {smi}")
    t1 = time.perf_counter()
    mp_hold_kernels(torch, mods)
    print(f"phase model parallel: {time.perf_counter() - t0:.1f} s (the ranks {spawn_s:.1f} s, "
          f"rank 0's parts "
          f"{ {k: round(r0[k]['phase_s'], 1) for k in ('updates', 'decode_sp', 'pipeline', 'cli')} }"
          f", the kernel holds {time.perf_counter() - t1:.1f} s), launches {launches}; {smi}")
    return launches


# serialized export, the compile cache and HuBERT-CTC for ASR-BLEU (phase
# 32): the DDIM denoiser call at the reference shape (B x T, the released
# widths) exported batch-polymorphic with its parameters baked, on the bf16
# module route and on int8 route fused_layer, and run again at B and
# EXPORT_SMALL_B; the NAR forward at long form exported with its parameters
# as input; a HuBERT-CTC recognizer at facebook/hubert-large-ls960-ft's
# widths (ASR_CONFIG's: 24 x 1024, 16 heads, FFN 4096, the layer-norm
# extractor, stable layer norm, 32 letters) on 45 s of audio, whose 2249
# frames send every self-attention to flash_attention in float32
EXPORT_SMALL_B = 16
EXPORT_NAR_REL = 1e-4  # the program's logits against eager, max-abs / scale
EXPORT_DENOISER = {"bf16": dict(), "fused_layer": dict(quant_int8=True, int8_route="fused_layer")}
# a denoiser call's launches on each route: every FiLM norm of the 12 layers
# (attention and FF), or one fused_layer a layer, and the WaveNet's 8 chains
EXPORT_LAUNCHES = {"bf16": {"rms_norm_film": 24, "wavenet_chain": 8},
                   "fused_layer": {"fused_layer": 12, "wavenet_chain": 8}}
# the route's existing bound against the plain versions, max-abs / scale
EXPORT_REL = {"bf16": CHAIN_REL_ERR, "fused_layer": LAYER_REL_ERR}
HUBERT_CTC_CONFIG = dict(ASR_CONFIG, model_type="hubert", architectures=["HubertForCTC"],
                         feat_proj_layer_norm=True, conv_pos_batch_norm=False)
HUBERT_CTC_SAMPLES = AUDIO_LONG_SAMPLES[0]  # 45 s at 16 kHz: 2249 frames
HUBERT_CTC_LAYERS = 24  # one flash_attention launch a layer
# phase 32's fresh process: imports the export module and the build module
# alone (no model code, no JAX), finds every kernel library already built,
# loads each artifact of plan.json and runs it on the inputs the parent saved
# against the parent's eager outputs; writes worker.json
EXPORT_WORKER = r"""
import json, sys, time
from pathlib import Path

import torch
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.utils.export import load_exported

root = Path(sys.argv[1])
plan = json.loads((root / "plan.json").read_text())
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
out = {"compiled": sorted(_build.build(_build.KERNELS)), "cases": {}}
out["build_s"] = time.perf_counter() - t0
for name, case in plan.items():
    t0 = time.perf_counter()
    call = load_exported(root / case["artifact"])
    load_s = time.perf_counter() - t0
    params = (torch.load(root / case["params"], map_location="cuda")
              if case.get("params") else None)
    for what in case["runs"]:
        args = torch.load(root / f"{name}_{what}_inputs.pt", map_location="cuda")
        want = torch.load(root / f"{name}_{what}_eager.pt", map_location="cuda")
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        t1 = time.perf_counter()
        got = call(params, *args) if params is not None else call(*args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        diff = (got.float() - want.float()).abs()
        out["cases"][f"{name} {what}"] = dict(
            load_s=load_s, run_s=run_s, launches=dict(_build.launch_counts),
            max_abs=diff.max().item(), scale=want.float().abs().max().item(),
            shape=list(got.shape), finite=bool(torch.isfinite(got).all()))
out["forbidden"] = sorted(m for m in sys.modules if m.startswith("diffnorm_tpu_torch.models")
                          or m.split(".")[0] in ("jax", "flax", "diffnorm_tpu"))
(root / "worker.json").write_text(json.dumps(out))
"""
# (e) under DIFFNORM_COMPILE_CACHE: builds rms_norm_film into that directory,
# launches it and reads which library file the process mapped
CACHE_WORKER = r"""
import json, sys, time

import torch
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.ops.norm import rms_norm_film
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache

enable_compile_cache()
t0 = time.perf_counter()
compiled = sorted(_build.build(["rms_norm_film"]))
build_s = time.perf_counter() - t0
x = torch.randn(4, 8, 512, device="cuda")
y = rms_norm_film(x, torch.randn(4, 1024, device="cuda"))
torch.cuda.synchronize()
with open("/proc/self/maps") as f:
    mapped = sorted({line.split()[-1] for line in f if "librms_norm_film" in line})
json.dump(dict(compiled=compiled, build_s=build_s, path=str(_build.library_path("rms_norm_film")),
               mapped=mapped, again=sorted(_build.build(["rms_norm_film"])),
               launches=dict(_build.launch_counts), finite=bool(torch.isfinite(y).all())),
          open(sys.argv[1], "w"))
"""


def export_denoiser_inputs(torch, model, b, seed=32):
    """One DDIM step's denoiser call as ddim_sample makes it: x_t [B, T, 128]
    float32, the time, the mask (the last row half masked), that step's
    precomputed FiLM projections and the positions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, T, 128, generator=g, device="cuda")
    times = torch.full((b,), START_STEP - 1, dtype=torch.int32, device="cuda")
    mask = torch.ones(b, T, dtype=torch.bool, device="cuda")
    mask[-1, T // 2:] = False
    with torch.no_grad():
        conds = model.precompute_step_conds(times.float()[None])
    step_cond = torch.utils._pytree.tree_map(lambda v: v[0].contiguous(), conds)
    return x, times, mask, step_cond, model.precompute_pos(mask)


def counted(torch, fn):
    """fn()'s result and the kernel launches it made."""
    from diffnorm_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.launch_counts.clear()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launch_counts)


def export_denoisers(torch, root: Path, plan: dict, smi):
    """(a): each route's denoiser call exported and saved; its inputs and
    eager outputs at B and EXPORT_SMALL_B saved for the worker. Returns the
    eager launches."""
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.utils.export import save_exported
    from diffnorm_tpu_torch.weights import pack_all

    torch.manual_seed(0)  # phase 3's weights
    with torch.device("cuda"):
        models = {name: LatentDiffusionModule(**kw) for name, kw in EXPORT_DENOISER.items()}
    models["fused_layer"].load_state_dict(models["bf16"].state_dict())
    pack_all(models["fused_layer"])  # int8 packs from the float32 masters
    launches = {}
    for name, model in models.items():
        model = model.to(torch.bfloat16).eval()
        inputs = export_denoiser_inputs(torch, model, B)
        small = torch.utils._pytree.tree_map(
            lambda v: v[:EXPORT_SMALL_B].contiguous(), inputs)

        def call(x, times, mask, step_cond, pos, model=model):
            return model.denoise(x, times, mask, step_cond=step_cond, pos=pos)

        for what, args in ((f"B{B}", inputs), (f"B{EXPORT_SMALL_B}", small)):
            eager, counts = counted(torch, lambda: call(*args))
            if counts != EXPORT_LAUNCHES[name]:
                fail(f"export {name}: the eager call launched {counts}, expected "
                     f"{EXPORT_LAUNCHES[name]}")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            torch.save(args, root / f"{name}_{what}_inputs.pt")
            torch.save(eager, root / f"{name}_{what}_eager.pt")
        t1 = time.perf_counter()
        nbytes = save_exported(root / f"{name}.dnx", call, inputs, batch_poly=True)
        export_s = time.perf_counter() - t1
        plan[name] = dict(artifact=f"{name}.dnx", runs=[f"B{B}", f"B{EXPORT_SMALL_B}"],
                          export_s=export_s, bytes=nbytes)
        print(f"export (a) denoiser {name} route: B{B} x T{T}, bf16, bake_params=True, "
              f"batch_poly=True: export + save {export_s:.2f} s, program {nbytes} bytes; {smi}")
        models[name] = None
        del model
    return launches


def export_nar(torch, root: Path, plan: dict, smi):
    """(c): the released NAR's forward at long form (LONG_B x LONG_FRAMES, so
    the decoder's encoder attention takes flash_attention) exported with its
    parameters as input; the state dict, inputs and eager logits saved for
    the worker. Returns the eager launches."""
    from diffnorm_tpu_torch.utils.export import module_fn, save_exported

    class Logits(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, src, src_lengths, tokens):
            return self.model(src, src_lengths, tokens, tokens)["logits"]

    wrapper = Logits(seeded_nar(torch, 0))
    src, lengths = s2st_inputs(torch, LONG_B, LONG_FRAMES)
    g = torch.Generator(device="cuda").manual_seed(60)
    tokens = torch.randint(4, wrapper.model.vocab_size, (LONG_B, S2ST_KW["max_len"]),
                           generator=g, device="cuda")
    args = (src, lengths, tokens)
    eager, counts = counted(torch, lambda: wrapper(*args))
    if counts.get("flash_attention", 0) == 0:
        fail(f"export (c): the eager long-form forward launched {counts}")
    params = wrapper.state_dict()
    torch.save(params, root / "nar_params.pt")
    torch.save(args, root / "nar_long_inputs.pt")
    torch.save(eager, root / "nar_long_eager.pt")
    t1 = time.perf_counter()
    nbytes = save_exported(root / "nar.dnx", module_fn(wrapper), args, params=params,
                           bake_params=False)
    export_s = time.perf_counter() - t1
    plan["nar"] = dict(artifact="nar.dnx", params="nar_params.pt", runs=["long"],
                       export_s=export_s, bytes=nbytes)
    print(f"export (c) NAR forward: B{LONG_B} x {LONG_FRAMES} frames, canvas "
          f"{S2ST_KW['max_len']}, bf16, bake_params=False: export + save {export_s:.2f} s, "
          f"program {nbytes} bytes (the state dict apart); eager launches {counts}; {smi}")
    return counts


def run_export_worker(root: Path, plan: dict, smi):
    """(b) and (c)'s runs, and (e)'s fresh process: EXPORT_WORKER on plan."""
    import os

    repo = Path(__file__).resolve().parent
    (root / "plan.json").write_text(json.dumps(plan))
    env = dict(os.environ, PYTHONPATH=str(repo))
    t1 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", EXPORT_WORKER, str(root)], cwd=str(root),
                          env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t1
    if done.returncode != 0 or not (root / "worker.json").exists():
        fail(f"export worker: exit {done.returncode}:\n{done.stderr[-3000:]}")
    out = json.loads((root / "worker.json").read_text())
    print(f"export (e) a fresh process found every kernel library: compiled "
          f"{out['compiled']} in {out['build_s']:.2f} s (nvcc --version only); the process "
          f"imported no model module nor JAX: {out['forbidden']}; its wall {wall:.1f} s")
    if out["compiled"] or out["forbidden"]:
        fail(f"export worker: compiled {out['compiled']}, imported {out['forbidden']}")
    launches = {}
    for key, case in out["cases"].items():
        name = key.split()[0]
        rel = case["max_abs"] / max(case["scale"], 1e-30)
        bound_ = EXPORT_NAR_REL if name == "nar" else EXPORT_REL[name]
        want = ({"flash_attention": 1} if name == "nar" else EXPORT_LAUNCHES[name])
        print(f"export (b) {key}: load {case['load_s']:.2f} s, first call {case['run_s']:.3f} "
              f"s, launches {case['launches']}, max-abs against eager {case['max_abs']:.3e} "
              f"(predicted 0.0; max-abs/scale {rel:.3e}, bound {bound_}), output "
              f"{case['shape']}; {smi}")
        short = ({k: v for k, v in case["launches"].items() if k in want} != want
                 if name != "nar" else case["launches"].get("flash_attention", 0) == 0)
        if short or rel > bound_ or not case["finite"]:
            fail(f"export {key}: launches {case['launches']}, max-abs/scale {rel:.3e}")
        for k, n in case["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return launches


def run_hubert_ctc(torch, root: Path, mods, smi):
    """(d): a seeded HuBERT-CTC checkpoint at hubert-large-ls960-ft's widths,
    through load_ctc_checkpoint, on HUBERT_CTC_SAMPLES of audio, kernels
    against plain versions. Returns the launches."""
    import numpy as np

    from diffnorm_tpu_torch.eval.asr_bleu import resolve_asr_model
    from diffnorm_tpu_torch.models.wav2vec2_ctc import (
        ctc_decode,
        load_ctc_checkpoint,
        normalize_waveform,
    )

    asr_dir = root / "hubert_ctc"
    t1 = time.perf_counter()
    write_asr_checkpoint(torch, asr_dir, seed=32, config=HUBERT_CTC_CONFIG)
    write_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ckpt = load_ctc_checkpoint(resolve_asr_model("en", str(asr_dir)), device="cuda")
    load_s = time.perf_counter() - t1
    if ckpt.model.prefix != "hubert" or not ckpt.model.encoder.layer_norm_first:
        fail("HuBERT-CTC: the checkpoint did not load as a stable-layer-norm HuBERT")
    rng = np.random.default_rng(32)
    wav = normalize_waveform(rng.normal(size=HUBERT_CTC_SAMPLES) * 0.1)
    x = torch.from_numpy(wav)[None].cuda()
    logits, counts = counted(torch, lambda: ckpt.model(x))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        ckpt.model(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    with torch.no_grad(), plain_versions(*mods):
        ref = ckpt.model(x)
    logits, ref = logits[0].float(), ref[0].float()
    cos = torch.nn.functional.cosine_similarity(logits, ref, dim=-1).min().item()
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    texts = [ctc_decode(v.argmax(-1).tolist(), ckpt.vocab, ckpt.tokenizer) for v in (logits, ref)]
    print(f"HuBERT-CTC (d): hubert-large-ls960-ft widths, {HUBERT_CTC_SAMPLES / SAMPLE_RATE:.0f} "
          f"s of audio ({logits.shape[0]} frames), float32: checkpoint written in {write_s:.1f} "
          f"s, load_ctc_checkpoint {load_s:.1f} s, forward {1e3 * wall:.1f} ms, launches "
          f"{counts} (expected flash_attention {HUBERT_CTC_LAYERS}, the JSON row "
          f"flash_attention_f32); against the plain versions: logits row-cos min {cos:.7f} "
          f"(bound {PREP_ROW_COS}), max-abs/scale {rel:.3e} (bound {PREP_REL}), argmax "
          f"agreement {agree:.5f}, transcripts equal {texts[0] == texts[1]} "
          f"({len(texts[0])} characters); {smi}")
    if (counts != {"flash_attention": HUBERT_CTC_LAYERS} or cos < PREP_ROW_COS
            or rel > PREP_REL or texts[0] != texts[1]):
        fail(f"HuBERT-CTC: launches {counts}, row-cos {cos}, rel {rel}, transcripts "
             f"{texts[0][:80]!r} vs {texts[1][:80]!r}")
    return {"flash_attention_f32": counts.get("flash_attention", 0)}


def check_cache_override(root: Path, proc, smi):
    """(e): CACHE_WORKER's result: rms_norm_film compiled into the override's
    host directory, and the library the process mapped is that one."""
    from diffnorm_tpu_torch.utils.compile_cache import host_fingerprint

    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    result = root / "cache.json"
    if proc.returncode != 0 or not result.exists():
        fail(f"compile cache override: exit {proc.returncode}:\n"
             f"{(root / 'cache.log').read_text()[-3000:]}")
    out = json.loads(result.read_text())
    where = (root / "cache" / f"host-{host_fingerprint()}").resolve()
    path = Path(out["path"]).resolve()
    ok = (out["compiled"] == ["rms_norm_film"] and path.parent == where
          and [Path(m).resolve() for m in out["mapped"]] == [path] and out["again"] == []
          and out["launches"] == {"rms_norm_film": 1} and out["finite"])
    print(f"export (e) DIFFNORM_COMPILE_CACHE={root / 'cache'}: compiled {out['compiled']} in "
          f"{out['build_s']:.1f} s into {Path(out['path']).parent.name}/, the process mapped "
          f"{[Path(m).name for m in out['mapped']]} from there, a second build compiled "
          f"{out['again']}, launches {out['launches']}; {smi}")
    if not ok:
        fail(f"compile cache override: {out}")


def run_export_cache_hubert(torch, mods, smi):
    """Phase 32: (a)-(c) the serialized export, (d) HuBERT-CTC, (e) the
    compile cache (the override's process runs beside (a)-(d)). Returns the
    launches of the phase's processes."""
    import os
    import tempfile

    t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        repo = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(repo), DIFFNORM_COMPILE_CACHE=str(root / "cache"))
        with open(root / "cache.log", "w") as log:
            cache_proc = subprocess.Popen(
                [sys.executable, "-c", CACHE_WORKER, str(root / "cache.json")], cwd=str(root),
                env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            plan = {}
            add(export_denoisers(torch, root, plan, smi))
            add(export_nar(torch, root, plan, smi))
            add(run_export_worker(root, plan, smi))
            add(run_hubert_ctc(torch, root, mods, smi))
        except BaseException:
            cache_proc.kill()
            cache_proc.wait()
            raise
        check_cache_override(root, cache_proc, smi)
    print(f"phase export, compile cache, HuBERT-CTC: {time.perf_counter() - t0:.1f} s, "
          f"launches {launches}; {smi}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "diffnorm_tpu_torch" / "csrc").is_dir():
        fail(f"no diffnorm_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from diffnorm_tpu_torch.generate.s2st import s2st_generate
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.ops import _build, ffpipe, norm
    from diffnorm_tpu_torch.ops import flash_attention as flash
    from diffnorm_tpu_torch.ops import fused_layer as fused
    from diffnorm_tpu_torch.ops import wavenet_chain as chain
    from diffnorm_tpu_torch.ops.quant import HEADLINE_KNOBS
    from diffnorm_tpu_torch.weights import pack_all

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"phase build: {time.perf_counter() - t0:.1f} s, nvcc for {sorted(logs)} "
          f"(sm_90a), torch {torch.__version__} CUDA {torch.version.cuda}")
    print(smi)

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    results = {"rms_norm_film": check_rms_norm_film(torch, norm),
               "wavenet_chain": check_wavenet_chain(torch, chain),
               "fused_layer": check_fused_layer(torch, ffpipe, fused),
               **check_ffpipe(torch, ffpipe)}
    int_mm_conv_ms = results.pop("int_mm_conv_ms")
    results["flash_attention"], results["flash_attention_f32"], flash_timed = \
        check_flash_attention(torch, flash)
    check_attention_routing(torch, flash)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s, every kernel within "
          f"tolerance of its plain version; {smi}")
    mods = (norm, chain, ffpipe, fused, flash)

    # 2b. gradients through the kernels' forwards
    check_gradients(torch, mods, smi)

    # 3. the main path at full width
    t0 = time.perf_counter()
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = LatentDiffusionModule()
        qmodel = LatentDiffusionModule(quant_int8=True)
        smodel = LatentDiffusionModule(quant_int8=True, int8_route="module",
                                       int8_knobs=HEADLINE_KNOBS)
    # the int8 models carry the same float32 weights and pack their int8
    # weights from them before the cast to bf16
    for int8_model in (qmodel, smodel):
        int8_model.load_state_dict(model.state_dict())
        pack_all(int8_model)
    model = model.to(torch.bfloat16).eval()
    qmodel = qmodel.to(torch.bfloat16).eval()
    smodel = smodel.to(torch.bfloat16).eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    inputs = dict(
        feature=torch.randn(B, T, 768, generator=g, device="cuda"),
        mask=torch.ones(B, T, dtype=torch.bool, device="cuda"),
        enc=torch.randn(B, T, 128, generator=g, device="cuda"),
        init=torch.randn(B, T, 128, generator=g, device="cuda"))
    ddim_sample(model, inputs["feature"], inputs["mask"], start_step=START_STEP,
                stride=START_STEP, enc_noise=inputs["enc"], init_noise=inputs["init"],
                device="cuda")  # warm-up: one denoiser call
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    units, recon, wall = run_main_path(torch, model, ddim_sample, inputs)
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = START_STEP - 1
    want = {"rms_norm_film": 24 * steps, "wavenet_chain": 8 * steps + 6}
    for name, n in want.items():
        if launches.get(name, 0) < n:
            fail(f"main path launched {name} {launches.get(name, 0)} times, expected >= {n}")
    if units.shape != (B, T) or units.min() < -4 or units.max() >= 1000:
        fail(f"units out of range: shape {tuple(units.shape)}, "
             f"[{units.min().item()}, {units.max().item()}]")
    if recon.shape != (B, T, 768) or not torch.isfinite(recon).all():
        fail("recon_feature is not finite [B, T, 768]")
    with plain_versions(*mods):
        units_ref, recon_ref, wall_ref = run_main_path(torch, model, ddim_sample, inputs)
    cos = torch.nn.functional.cosine_similarity(
        recon.float().reshape(-1, 768), recon_ref.float().reshape(-1, 768), dim=-1)
    agree = (units == units_ref).float().mean().item()
    if cos.min().item() <= PATH_ROW_COS:
        fail(f"main path recon_feature row-cos {cos.min().item():.5f} against the plain run")
    rtf = B * T * SECONDS_PER_UNIT / wall
    print(f"main path: B{B}xT{T}, {steps} DDIM steps, bf16: wall {wall:.4f} s, RTF {rtf:.2f}, "
          f"launches {launches}, peak {peak_gb:.2f} GB; plain-version run {wall_ref:.4f} s; "
          f"recon row-cos min {cos.min().item():.5f} mean {cos.mean().item():.5f}, "
          f"unit agreement {agree:.4f}; {smi}")
    profile_run(torch, lambda: run_main_path(torch, model, ddim_sample, inputs), wall)
    print(f"phase main path: {time.perf_counter() - t0:.1f} s")

    # 3b. the int8 main path at full width, on each kernel route
    launches.update(run_int8_routes(torch, qmodel, ddim_sample, inputs, units, smi, mods))
    del qmodel

    # 3c. float32 through the float32 kernels
    run_f32_path(torch, ddim_sample, inputs, mods, smi)

    # 3d. JAX's serving headline: int8 module route, static scales
    run_int8_static(torch, smodel, ddim_sample, inputs, units, smi, mods)
    del smodel

    # 4. the entry point
    run_cli(torch, model, smi)
    del model

    # 5.-7. the S2ST chain at CVSS length, in long form, and its entry point
    nar, voc = s2st_models(torch)
    cvss = s2st_phase(torch, "CVSS length", s2st_generate, nar, voc,
                      s2st_inputs(torch, S2ST_B, S2ST_FRAMES), mods, smi, long_form=False)
    launches["flash_attention"] = s2st_phase(
        torch, "long form", s2st_generate, nar, voc, s2st_inputs(torch, LONG_B, LONG_FRAMES),
        mods, smi, long_form=True)["launches"]["flash_attention"]
    run_s2st_cli(torch, nar, voc, smi)

    # 16. the int8 static NAR decode (bench.py --e2e's default) beside phase 5
    launches["flash_attention"] += run_s2st_int8(torch, s2st_generate, nar, voc, cvss, mods,
                                                 smi)
    del nar, voc

    # 8.-9. training of both main-path stages, and through cli.train
    run_train(torch, mods, smi)
    run_train_cli(torch, smi)

    # 10.-11. NAR S2UT training, and through cli.train -> cli.s2st
    run_train_nar(torch, mods, smi)
    run_train_nar_cli(torch, smi)

    # 12.-14. prep: the bench shape, the long form through flash_attention,
    # and cli.get_manifest -> cli.prepare
    hubert, hubert_bf16 = prep_models(torch)
    run_prep_bench(torch, hubert, hubert_bf16, smi)
    del hubert_bf16
    launches["flash_attention_f32"] = run_prep_long(torch, hubert, mods, smi)
    run_prep_cli(torch, hubert, smi)
    del hubert

    # 15. eval: cli.generate -> unit BLEU -> cli.generate_waveform -> ASR-BLEU
    eval_flash, hyp_units = run_eval(torch, smi)
    launches["flash_attention"] += eval_flash

    # 17. recipe stage 6, the code-HiFi-GAN fine-tune, then cli.train_vocoder
    run_train_vocoder(torch, smi)
    run_train_vocoder_cli(torch, hyp_units, smi)

    # 18. checkpoints in: fairseq envelopes -> cli.convert_checkpoint -> the CLIs
    ckpt_launches = run_checkpoints_in(torch, mods, smi)
    for name, n in ckpt_launches.items():
        launches[name] += n

    # 19. the NAR model's options: stacked units, aux and CTC heads, target
    # speakers, the multi-speaker vocoder; training, decode, S2ST, the CLIs
    launches["flash_attention"] += run_options(torch, mods, smi)

    # 20. the S2ST options left out: ensembles, the history and the chunked
    # decode, encoder_remat, the augments, repr_to_speech
    launches["flash_attention"] += run_s2st_extras(torch, mods, smi)

    # 21. the training remainder: the prompt-conditioned normalizer, the
    # continuous tasks, the optimizers and schedules
    for name, n in run_training_remainder(torch, mods, smi).items():
        if name in launches:
            launches[name] += n

    # 22. the recipe's last training options: loader workers and read-ahead,
    # sharded --data, --quant-int8 training, the int8 vocoder, the bridge
    for name, n in run_recipe_options(torch, smi).items():
        if name in launches:
            launches[name] += n

    # 23. the AR S2UT family: the KV-cached beam decode, s2ut_transformer,
    # AR training, cli.train -> cli.generate and the AR reranker
    launches["flash_attention"] += run_ar_s2ut(torch, mods, smi)

    # 24. the two-pass S2ST families and the spectrogram decoders: UnitY,
    # s2spect_conformer, Translatotron2; decode, training, the CLIs
    launches["flash_attention"] += run_two_pass(torch, mods, smi)

    # 25. text-input TTS (tts_transformer, FastSpeech2) and the S2T model:
    # the rollout, FastSpeech2 in float32 and bf16, the S2T decode, training,
    # the CLIs
    for name, n in run_tts_s2t(torch, mods, smi).items():
        launches[name] += n

    # 26. text machine translation: transformer_wmt_en_de_big's beam decode,
    # the text CMLM's mask-predict, the Levenshtein decode, their training,
    # cli.preprocess -> train -> generate -> interactive -> score
    launches["flash_attention"] += run_text_mt(torch, mods, smi)

    # 27. SEDD (the sampler and the refinement, bf16 and float32), the unit
    # LM, IDDPM over the Denoiser, the BASE MoE layer; their CLIs
    for name, n in run_sedd_lm(torch, mods, smi).items():
        launches[name] += n

    # 28. wav2vec2 and HuBERT pretraining and the CTC fine-tune: an update of
    # each at base width, the long-form validation forwards and CTC decodes
    # through flash_attention, the CLIs
    for name, n in run_audio_pretrain(torch, mods, smi).items():
        launches[name] += n

    # 29. TranSpeech's baseline normalization (cli.speech_norm), lightconv /
    # dynamicconv, the MMA alignment, and the dummy tasks, hydra_train,
    # --user-dir and --config through cli.train
    for name, n in run_speech_norm_runtime(torch, mods, smi).items():
        launches[name] += n

    # 30. data parallelism: two ranks on the card over gloo (DDIM, the
    # normalizer's updates replicated / ZeRO / FSDP, the long-form S2ST
    # decode, cli.train -> cli.validate, cli.diff_norm_synthesis
    # --data-parallel 2), and one rank over NCCL
    for name, n in run_data_parallel(torch, mods, smi).items():
        launches[name] += n

    # 31. the model axis: two ranks on the card over gloo (the normalizer's
    # tensor-parallel update, the long-form decode at tensor parallel 2,
    # the sequence-parallel conformer, the GPipe pipeline, cli.train
    # --model-parallel 2 --profile --heartbeat-timeout -> cli.validate)
    for name, n in run_model_parallel(torch, mods, smi).items():
        launches[name] += n

    # 32. the serialized export (the DDIM denoiser call on the bf16 and
    # fused_layer routes, batch-polymorphic and baked; the long-form NAR
    # forward with its parameters as input) run in a process without model
    # code, HuBERT-CTC at hubert-large's widths through flash_attention, and
    # the compile cache (found again; rebuilt under DIFFNORM_COMPILE_CACHE)
    for name, n in run_export_cache_hubert(torch, mods, smi).items():
        launches[name] += n

    sources = {
        "rms_norm_film": ("rms_norm_film.cu", "diffnorm_tpu/ops/pallas_norm.py:34"),
        "wavenet_chain": ("wavenet_chain.cu", "diffnorm_tpu/ops/pallas_wavenet.py:66"),
        "fused_layer": ("fused_layer.cu", "diffnorm_tpu/ops/pallas_block.py:222"),
        "ffpipe_layer": ("int8_ff.cu", "diffnorm_tpu/ops/pallas_ffpipe.py:257"),
        "ffpipe_layer2": ("int8_ff.cu", "diffnorm_tpu/ops/pallas_ffpipe.py:316"),
        "flash_attention": ("flash_attention.cu", "diffnorm_tpu/ops/pallas_attention.py:87"),
        "flash_attention_f32": ("flash_attention.cu", "diffnorm_tpu/ops/pallas_attention.py:87"),
    }
    kernels = [dict(name=name, route="cuda",
                    source=f"diffnorm_tpu_torch/csrc/{sources[name][0]}",
                    replaces=sources[name][1], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))
               for name, r in results.items()]
    conv_us = results["fused_layer"]["conv_us"]
    print(f"int8 FF reference: torch._int_mm for the conv-tap products alone "
          f"{int_mm_conv_ms:.4f} ms per layer (no single PyTorch call computes a sublayer); "
          f"fused_layer's conv-tap GEMM "
          + (f"{conv_us / 1e3:.4f} ms" if conv_us is not None else "not measured"))
    print(f"flash_attention at PERFORMANCE.md's B2 H8 T4096 D64: {flash_timed['PERFORMANCE.md']}")
    print(f"flash_attention at phase 15's shape (k/v [2,8,3072,64]): {flash_timed['eval path']}")
    print(f"flash_attention at phase 23's decode step (q [10,8,1,64], k/v [10,8,2112,64]): "
          f"{flash_timed['AR decode step']}")
    print(f"flash_attention at phase 23's S2T encoder ([2,8,2112,64]): "
          f"{flash_timed['S2T encoder']}")
    for what, shape in (("UnitY decode step", "q [10,8,1,32], k/v [10,8,2112,32]"),
                        ("Translatotron2 decode step", "q [10,4,1,128], k/v [10,4,2112,128]"),
                        ("s2spect decode step", "q [2,4,1,128], k/v [2,4,2112,128]")):
        print(f"flash_attention at phase 24's {what} ({shape}): {flash_timed[what]}")
    for what in ("FastSpeech2 decoder", "FastSpeech2 decoder float32"):
        print(f"flash_attention at phase 25's {what} ([8,2,2048,128], keys "
              f"{FS2_FLASH_KEYS}): {flash_timed[what]}")
    for what, shape in (("MT encoder", "[2,16,2112,64]"),
                        ("MT decode step", "q [8,16,1,64], k/v [8,16,2112,64]"),
                        ("CMLM decoder", "q [10,8,256,64], k/v [10,8,2112,64]"),
                        ("S2T encoder", "the 8-head text encoder's [2,8,2112,64]"),
                        ("path", "the Levenshtein decoder's q [2,8,256,64], k/v [2,8,2112,64]")):
        print(f"flash_attention at phase 26's {what} ({shape}): {flash_timed[what]}")
    for what in ("SEDD self-attention", "SEDD self-attention float32"):
        print(f"flash_attention at phase 27's {what} ([2,8,2112,64], keys [2112, 1056]): "
              f"{flash_timed[what]}")
    for what in ("HuBERT eval long form", "HuBERT eval long form float32"):
        print(f"flash_attention at phase 28's {what} ([2,12,2249,64], keys "
              f"{list(AUDIO_LONG_FRAMES)}): {flash_timed[what]}")
    for what in ("HuBERT long form", "HuBERT longest chunk", "float32 path"):
        print(f"flash_attention float32 {what}: {flash_timed[what]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
