#!/usr/bin/env python3
"""Drive the PyTorch port's FastSpeech 2 (transformer and conformer, and
its discrete mode), AR Transformer-TTS (with and without GST, and with
the Tacotron 2 decoder) and SQ-VAE FastSpeech 2 synthesis and training,
checkpoint averaging, its features, its vocoder and its serving layer on
one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; exits
non-zero, printing no result, without them. Phases, each fatal on failure
and each printing its wall time:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the paths (the Hopper design of the models'
   attention: K1/K1-d, K3-f/K3-d and K6/K6-d csrc/flash_fwd_sm90.cu and
   the fused K2, K3 and K6 backward csrc/flash_bwd_sm90.cu; the simple K1
   and K1-d with
   K3's and K6's forward, K2 with K3's and K6's backward; the Hopper
   design of the conformer's relative attention, K4/K4-d
   csrc/flash_relpos_fwd_sm90.cu and the fused K5
   csrc/flash_relpos_bwd_sm90.cu; the simple K4 and K4-d, K5), in
   parallel, from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, TF32 off:
   K1 (csrc/flash_attention_fwd.cu) and K4 (csrc/flash_relpos_fwd.cu):
   fp32 at 1e-4 on O and lse, bf16 against the plain version in fp32 on
   the same bf16 inputs at 2e-2 on O and 1e-3 on lse, rows with no valid
   key exactly 0, O bit for bit the same on a second launch; kernel,
   plain and library times at the synthesis shapes. K1-90, the Hopper
   design (csrc/flash_fwd_sm90.cu), likewise in bf16 (and at d = 64).
   K1-d (dropout 0.1) and K2 (csrc/flash_attention_bwd.cu, at dropout 0
   and 0.1 on the same seed) at k_len in {0, 1, 65, T}, T = 1000,
   T_q = 300 != T_k = 700, and the train step's (16, 4, 1024, 96) with
   k_len in {0, 1, 65, T}, with T_q = 768, and with its batch's mel
   lengths as k_len: O, dq, dk, dv at 1e-4 (fp32) and 2e-2 (bf16) times
   that tensor's own max|ref|, lse as K1; dk and dv exactly 0 for keys
   at or past k_len; in bf16 on both designs, the Hopper one (K1-d-90
   and the fused K2-90, csrc/flash_bwd_sm90.cu), whose launches must go
   to its kernels, and the simple one; every launch on its id's counter
   and O bit for bit on a second launch. K3, the causal mode of the same
   kernels, likewise (the Hopper design's K3-f-90, K3-d-90 and the fused
   K3-90, and the simple one) at the AR train step's (16, 4, 511, 96)
   with k_len T, 0, 1, 65 and the AR batch's decoder groups, at T_q !=
   T_k both ways and at d = 64. K4/K4-d (csrc/flash_relpos_fwd.cu, with
   dropout) and K5 (csrc/flash_relpos_bwd.cu, dq and dk/dv/dP), and in
   bf16 their Hopper design K4-90/K4-d-90 and the fused K5-90
   (csrc/flash_relpos_fwd_sm90.cu, csrc/flash_relpos_bwd_sm90.cu), at
   dropout 0 and 0.1 on the same seed, at k_len in {0, 1, 65, T}, T in
   {1024, 1000, 511}, d in {64, 96} (bf16, both designs; fp32 at T =
   1000, d = 96), and the conformer train step's (16, 4, 1024, 96) with
   its batch's mel lengths: O, dq_u, dq_v, dk, dv and dP at 1e-4 (fp32)
   and 2e-2 (bf16) of each tensor's own max|ref|, dk and dv exactly 0
   past k_len, O bit for bit the same on a second call, each launch on
   its id's counter. K4-90 also as K4 at the synthesis shapes. K6/K6-d
   and K6's backward likewise, in bf16 on both designs (the Hopper one's
   K6-90/K6-d-90 and fused K6-bwd-90, the bias mode of
   csrc/flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu; the simple one's
   bias argument of csrc/flash_attention_fwd.cu and
   csrc/flash_attention_bwd.cu, dq with dbias and dk/dv) at k_len in {0,
   1, 65, T}, T in {1000, 1024}, d in {64, 96}, fp32 at T = 1000, d = 96;
   and T_q = 300 != T_k = 700, where the rule sends bf16 to the simple
   kernels (T_k is not a multiple of 8): O, dq, dk, dv and dbias, dbias,
   dk and dv exactly 0 past k_len, O, dk, dv and dbias bit for bit on a
   second launch, each launch on its id's counter;
4. for each FastSpeech 2 flagship, the transformer one and the conformer
   one of egs/fastspeech2_conformer_ljspeech.py (d 384, 6+6 layers, 4
   heads of 96, random weights from seed 0):
   (a) teacher-forced forward (B=2, L=128, T=768), card fp32 (kernel
       path) against the CPU fp32 at 1e-3 max abs on mel_post, and card
       bf16 amp against the CPU fp32 at 5e-2 * max(1, max|ref|) (bf16
       keeps ~3 significant digits through 12 layers and the postnet);
   (b) synthesize_fastspeech2 with predicted durations at B=1 / 768 frames
       and B=8 / 2048 frames: a main path, whose kernel launches are
       counted with every count set to 0 just before it (6 launches of
       the path's kernel per call, one per decoder layer -- K1-90 for the
       transformer, K4-90 for the conformer -- and none of the others), with
       ms and RTF;
   (c) the synthesis CLI as a subprocess on a 3-line script;
5. training, the transformer FastSpeech 2 flagship at full width (bf16
   amp, dropout 0.1, Noam warmup 4000, clip 1.0):
   (a) one step on the card against one on the CPU from the same weights,
       fp32 with every dropout 0 (B=2, L=128, mel bucket 768, so the
       decoder takes K1 and K2) and warmup_step 10, so that Adam's first
       update is ~lr * sign(g): the loss; each gradient at 2e-2 of its own
       max|g|, 5e-3 for the decoder attention weights (key and
       pre-BatchNorm conv biases, zero but for rounding, below 1e-5 of the
       largest); each update against the CPU's where the two gradients
       bound their difference below 1e-3 lr; BatchNorm statistics; then
       bf16 amp on the card against the CPU's loss, grad_norm and the
       decoder attention weights' gradient norms;
   (b) the train step, the main path of training, on a fixed batch (B=16,
       text bucket 128, mel bucket 1024, 600-1000 frames per row): 3
       warm-up steps, then 10 timed with CUDA events, every launch count
       set to 0 just before (6 K1-d-90 and 6 K2-90 per step, no other
       kernel); ms/step, mel frames/s, peak memory; the loss
       finite; one step under torch.profiler, printing the top 10 device
       operations (run in phase 9); then 20 steps with warmup_step 100
       whose loss must fall;
   (c) cli/train.py for 3 steps on a synthetic corpus (32 utterances of
       300-900 frames) and cli/synthesize.py on the checkpoint it saved
       (the corpus written here; the CLIs of 5, 6 and 15 run after 15,
       every training CLI at once with 16(e)'s, then every synthesis CLI
       at once);
   (d)-(f) the conformer flagship's training likewise: the card-vs-CPU
       step (decoder on K4 and K5 in fp32, on K4-90 and K5-90 alone in
       bf16; its decoder self-attention weights,
       linear_pos and the position biases at the attention tolerance,
       each with a non-zero card gradient), the timed step (6 K4-d-90 and
       6 K5-90 per step, no other kernel) and its profile, the
       two CLIs;
6. the AR Transformer-TTS flagship of egs/transformer_tts_ljspeech.py
   (the same widths, r 2, prenet dropout 0.5), each path counted from 0:
   (a) the teacher-forced eval forward over 300 decoder groups, 6 K3-f
       launches in fp32 and 6 K3-f-90 in bf16 amp and nothing else, card
       fp32 against the CPU at 1e-3 and bf16 amp at 5e-2 of max(1,
       max|ref|);
   (b) the KV-cached decode loop for 300 steps, no kernel launched, each
       step's group against the teacher-forced forward of the frames it
       fed itself (on K3-f) at 1e-3 of max(1, max|ref|);
   (c) synthesize_transformer_tts at B=1 and B=8, 500 decode steps, the
       decode replayed from its CUDA graph, no kernel launched: the
       graph's mel and lengths bit for bit the eager loop's, with no row
       stopping and with a stop bias at which rows stop at different
       steps; ms per call and per step and RTF of both; a graphed call of
       100 steps timed, then under the profiler (run in phase 9);
   (d)-(f) training as in 5: the card-vs-CPU step (383 decoder groups on
       the simple K3-f and K3's backward in fp32, on K3-f-90 and K3-90
       alone in bf16), the timed step (6 K3-d-90 and 6 K3-90 per step, no
       other kernel), the two CLIs;
7. each kernel at its main path's own captured input (K1-90, K4-90: the
   first decoder layer of the B=8 synthesis call; K1-d-90 and K2-90,
   K3-d-90 and K3-90: the first decoder layer of the FastSpeech 2 and the
   AR train step, held there against their plain versions as in 3;
   K4-d-90 and K5-90: the first decoder layer of the conformer train
   step, likewise, the library
   yardstick SDPA with the relative bias (for K5 its backward with the
   bias's gradient, the rel_shift adjoint and two products);
   K3-f-90: the first decoder layer of 6(a)'s bf16 forward): kernel, plain
   and library ms, bound (for K3 over the causal pairs the inputs
   attend), error. The simple design's K1, K1-d, K2 dq and K2 dk/dv, K3-f,
   K3-d, K3 dq and K3 dk/dv, K4, K4-d, K5 dq and K5 dk/dv/dP on the same
   inputs, the same-run A/B ("A/B at ..." lines). K6-90, K6-d-90 and the
   fused K6-bwd-90 at the conformer step's input with the bias
   rel_shift(q_v P^T) built in device memory, and the simple K6, K6-d,
   K6-dq and K6-dkdv on the same input (the A/B): the path that launches
   them is the route A/B of the conformer's attention core (route 1
   K4-d-90 and K5-90, route 2 the bias then K6-d-90 and K6-bwd-90),
   counted from 0, O and the five gradients of the two routes within 2e-2
   of each one's max|ref|, and the routes' forward and forward+backward
   times;
8. attention-path timing, kernel against masked-fill, at T in
   {128, 256, 768, 2048} for the transformer's attention, {128, 256,
   512, 1024, 2048} for the conformer's (K4-90), and for the AR
   decoder's causal self-attention at T in {128, 256, 511, 1024, 2048},
   forward and forward with backward;
9. the profiles of one step of 5(b), 5(e), 6(e), 15(d), 16(d), 18(a)'s
   two and 18(b)'s and of 6(c)'s graphed decode at B=1 and B=8 over
   PROFILE_AR_STEPS groups (device operations per decode step, the
   copies among them, the bf16 weight copies the graph reads), each on
   the warm state or model its phase timed (kept for it, not built
   again), after every timed phase: a profiler pass slows the host work
   of the rest of its process; also one vocoder GAN step (phase 13);
   each profile's wall time;
10.-14. features and the vocoder, run after 6 and before 7, random
   weights from seed 0 at full width (HiFi-GAN V1: 512 channels, rates
   8·8·2·2, MRF kernels 3/7/11; the iSTFT vocoder: 8 ConvNeXt layers of
   512; the discriminator's MPD periods 2, 3, 5, 7, 11 and MSD's three
   scales), each printing its wall time:
   10. log_mel_spectrogram, yin_f0 and energy_per_frame on 16 seeded
       waveforms of 10 s (harmonic tones, noise, a silent stretch), card
       against CPU: log-mel within 1e-3 (natural log), energy 1e-4 of
       max|ref|, YIN's voicing the same at 99.9 % of frames and f0 within
       0.1 Hz where both are voiced; ms per second of audio;
   11. the three generators on a (1, 64, 80) mel and the discriminator's
       logits and every feature map on a (2, 8192) waveform, card fp32
       against CPU fp32 within 1e-3 of each output's max|ref|;
   12. vocoded synthesis, the slice's main path: the transformer
       flagship (K1-90, 6 launches per call, counted from 0, no other
       kernel) then HiFi-GAN V1 at B=1 / 768 and B=8 / 2048 frames: ms of
       the acoustic model and of the vocoder (fp32, fp32 with cuDNN's
       TF32 as the CLI runs it, bf16 autocast), RTF, peak memory; then
       Griffin-Lim (32 iterations) at B=1;
   13. the vocoder GAN step, B=16 x 8192 samples, G under bf16 amp,
       cuDNN TF32 on (the CLI's): ms per step (CUDA events, median of 10
       after 3), samples/s, peak memory, queued profile; 20 steps on one
       batch with loss_mel falling; a fine-tuning step
       (predicted_mel_inputs); one fp32 step (TF32 off) at B=2 on the card
       and the CPU from the same state: losses within 1e-4, each of D's
       and G's gradients within 2e-2 of its own max|g|, the updates as
       5(a);
   14. cli/prepare_data.py on WAVs written there, cli/train_vocoder.py
       for 3 steps with a save and cli/synthesize.py --wav on phase 4(c)'s
       transformer checkpoint, the three at once, then --vocoder (its
       export) on that checkpoint, all with --device cuda, all in the one
       phase that runs every CLI at once (after 15): every WAV of
       frames x 256 samples (Griffin-Lim's (frames - 1) x 256) and
       finite; load_reference_checkpoint of a
       ``module.``-prefixed copy of that checkpoint, bit for bit.
15.-16. the two other families, run after 14 and before 7, random weights
   from seed 0 at the flagship's widths (15 at LATER_DEPTH, 3 + 3
   layers, for the run's time; 16 at full depth), their data from a
   generator of their own (seed 15), each path counted from 0:
   15. the GST AR model (egs/transformer_tts_ljspeech.py with gst = True;
       the style token attention's query weights and tokens scaled x10,
       ``gst_model``, so the style follows the reference): (a) the eval
       forward as 6(a) with a (1, 400, 80) reference mel, 6 K3-f or 6
       K3-f-90 and nothing else; (b) synthesize_transformer_tts with the
       reference at B=1 and B=8, 500 steps, no kernel, the graph bit for
       bit the eager loop, a second reference (650 frames) another mel,
       ms per step and RTF; (c) the card-vs-CPU step as 6(d), the token
       attention's dropout at 0, every GST weight (conv, BatchNorm, GRU,
       tokens, MHA) with a non-zero card gradient within 2e-2 of its own
       max|g|, the BatchNorm2d statistics as the others; (d) the timed
       bf16 step at the AR batch, 6 K3-d-90 and 6 K3-90 per step, the
       loss falling over 20 steps, a queued profile; (e) cli/train.py
       for 3 steps, then cli/synthesize.py --ref_mel on its checkpoint;
   16. the SQ-VAE FastSpeech 2 (model = "SQFastSpeech2"): (a) the eval
       forward (B=2, L=128, 768 frames, durations predicted from the
       quantized encoder output) card fp32 against CPU fp32 at 1e-3 of
       max(1, max|ref|), where the nearest code differs at a tie (two
       distances within ARGMIN_TIE) the card takes the CPU's, those rows
       counted and printed, any other difference fatal; (b)
       synthesize_fastspeech2 as 4(b), 6 K1-90 per call; (c) the card-vs-
       CPU step as 5(a), the Gumbel noise the same on both sides
       (``fixed_gumbel``), every loss term (sq_vae_loss and the
       perplexity among them) within 1e-4 of max(1, |CPU|), the codebook,
       log_var_q_scalar and duration predictor with non-zero card
       gradients; (d) the timed bf16 step at the FastSpeech 2 batch, 6
       K1-d-90 and 6 K2-90 per step, as 5(b); (e) cli/train.py for two
       epochs with a save each, the SQ model and the transformer
       flagship, and one step of a use_sq_vae FastSpeech 2, at once with
       every other CLI of the run (4(c), 5, 6, 14, 15 and 19; a phase of
       their own before 16); then
       cli/average_checkpoints.py --last 2 on both, each average equal to
       the float64 mean of its epochs' state_dicts; then
       cli/synthesize.py on the transformer flagship's average.

17. serving (infer/engine.py, infer/server.py, infer/streaming.py,
   infer/quantize.py, cli/serve.py), run after 16 and before 7, random
   weights from seed 0 at the flagships' full width and LATER_DEPTH
   (phases 17-19 alike), fatal on any failure:
   (a) the transformer FastSpeech 2's TTSEngine (bf16 amp, batch 8, 8
       frames per phone, text buckets 32/64/128, mel budgets
       256/512/1024): warmup seconds per bucket; per bucket one call of 8
       requests, counted from 0 (6 K1-90, no other kernel), each mel bit
       for bit synthesize_fastspeech2 on the same padded tensors; ms per
       call and audio-seconds per second;
   (b) TTSServer on 127.0.0.1, port 0, batch_window_ms 5: 64 /synthesize
       requests from 16 client threads (20-120 phones, ids 1-151, seed
       0), first on an fp32 engine (amp off, TF32 off) whose every
       response's durations and mel_frames equal the text's solo call at
       the bucket its batch padded it to, mel within 1e-4 of max|ref|,
       then on (a)'s engine: latency p50/p95/max, requests/s, /metrics;
       then max_queue 4 under 32 simultaneous requests while the engine is
       busy (its lock held): some 503, no other error;
   (c) streams with HiFi-GAN V1 (fp32, TF32 off) on fp32 engines of batch
       1 at bucket 64: FastSpeech 2 and the AR flagship (segments of 32
       steps), time to first audio and total, the pcm within 1e-4 of
       max|audio| of the one-shot audio; two AR streams advanced in turn
       with server batch requests at the same graph key between their
       segments, each equal to its one-shot audio; an AR stream that stops
       inside a segment;
   (d) int8: (a)'s engine with quantize="int8": max|dmel| / max|mel| and
       mean|dmel| / mean|mel| at the bf16 engine's durations, and at its
       durations, pitch and energy, with the share of frames whose pitch or
       energy bin moves (beside the fp32 engine's), requests with a changed
       duration, ms per call, card weight bytes, each call's peak memory;
       one AR int8 call, its graph's bf16 weight copies equal to the
       dequantized parameters;
   (e) one conformer engine call (6 K4-90, no other kernel), one GST call
       with a reference mel and the refusal without it, the AR engine's
       warmup (a graph capture per bucket) and a batch call (no kernel);
   (f) cli/serve.py --port 0 as a subprocess: a POST, a Griffin-Lim wav
       request, /metrics, then SIGINT and exit 0 within 10 s.
18. speaker, accent and hop-size conditioning, run after 17 and before 7,
   random weights from seed 0 at the flagships' full width, data from a
   generator of seed 18, fatal on any failure:
   (a) the transformer flagship with 512-d x-vectors in the encoder, the
       middle and the decoder, hop-size classes, the CTC tap and SSIM:
       one train step card fp32 against CPU fp32 and its bf16 step (as
       5(a)); its bf16 train step beside the plain flagship's on one
       batch at TRAIN_BATCH, 10 timed steps of each in turn, twice
       (ms/step over the 20, frames/s, own peak memory; 6 K1-d-90 and 6
       K2-90 a step), both states kept for their profiles (phase 9);
       CTC over (16, 1024, 152) and the LSTM over (16, 1024, 384),
       forward and backward; synthesis at B=8 / 2048 frames with 8
       x-vectors in bf16 (6 K1-90), timed in turn with the plain
       flagship's call, and, in fp32, each row against its solo call
       padded to the batch's shape, within 1e-6 of max|ref|;
   (b) the conformer with 247 speaker ids in both stacks, accents,
       use_pos and use_rnn_length: card fp32 against CPU fp32 and its
       bf16 step (as 5(a)); 10 timed bf16 steps on (a)'s batch (6
       K4-d-90 and 6 K5-90 a step), its state kept for its profile;
       synthesis at B=1 / 768 (6 K4-90);
   (c) the AR flagship with 247 speaker ids (spk_emb_vers 1): two graphed
       B=8 calls with other speakers, each bit for bit its eager loop, ms
       per decode step beside the plain AR model's; spk_emb_vers 2
       teacher-forced, card fp32 against CPU fp32;
   (d) (a)'s model in fp32 behind TTSEngine: a batch of 8 voices, 4
       TTSServer requests with "speaker" and a stream with a speaker,
       each against its solo call at its bucket, within 1e-4 of max|ref|.
   The launches of its conditioned main paths (the timed steps and the
   synthesis calls of (a) and (b), each counted from 0) are added to
   the kernels line's; the card-vs-CPU checks' are not.
19. the other model families, run after 18 and before 7, random weights
   from seed 0 at full width, data from a
   generator of seed 19, fatal on any failure:
   (a) the AR flagship with the Tacotron 2 decoder (d 384, r 2, LSTM
       cells 1536 wide): one train step card fp32 against CPU fp32 with
       zoneout and the prenet dropout off (as 5(a), at mel bucket 128:
       63 decoder steps; no kernel launches, the decoder's attention
       weights at 2e-2 of their max|g|); its bf16 step at TRAIN_BATCH
       (511 eager decoder steps; 10 timed, the state kept for its
       profile, which records the card alone); synthesize_tacotron2 at
       B=1 and B=8,
       500 steps, replaying CUDA graphs of 8 steps, bit for bit the eager
       loop's with and without the stop rule firing (ms per step, RTF);
       its training then synthesis CLIs run with phase 5's;
   (b) the transformer flagship in the discrete mode (640 outputs, two
       streams of 320 codes, pad 320): card fp32 against CPU fp32 (K1,
       K2) and its bf16 step (K1-90, K2-90); its bf16 step at TRAIN_BATCH
       (6 K1-d-90 and 6 K2-90 a step); the LSTM language model (vocab
       320, hidden 512, 4 layers) forward, card against CPU;
   (c) the SQ-VAE FastSpeech 2 with 247 speaker ids in both stacks and
       accents: card fp32 against CPU fp32 (the Gumbel noise drawn once);
       synthesis at B=8 / 2048 in bf16 (6 K1-90), and in fp32 each row
       against its solo call within 1e-6 of max|ref|.
   The launches of its main paths ((b)'s timed steps, (c)'s synthesis
   call) are added to the kernels line's.
20. the kernels as custom ops and serving export, run after 19 and
   before 7: torch.library.opcheck of every tts_port op
   on the card (bf16: plain with dropout, causal, a bias with dropout;
   fp32: plain with dropout; the relative ops alike); the host µs of a
   K1-90 launch through its op against its CUDA implementation called
   directly; TTSEngine.export of the transformer flagship at full depth
   (bf16 amp, B=8, bucket 128: 1024 frames, with HiFi-GAN V1) and of the
   AR flagship at LATER_DEPTH (B=8, bucket 32: a budget of 128 decode steps, a stop
   bias at which its rows stop at different steps before it), each artifact
   loaded and called in a fresh python3 that imports only torch and the
   two ops modules, on the engine's inputs: lengths and durations equal,
   the mel and the samples within EXPORT_TOL of max(1, max|ref|), the
   FastSpeech 2 artifact's call 6 K1-90 launches (its process's counter);
   each artifact's ms beside the engine's, the AR one's per decode step
   beside the graphed decode's.
21. data and sequence parallelism, RAdam and remat, run after 20 and
   before 7, the flagships at full depth, fatal on any failure:
   (a) two ranks over gloo on the one card (two processes: NCCL takes one
       rank per card), the transformer flagship (bf16 amp, dropout 0)
       wrapped by train.trainer.distribute, TRAIN_BATCH split 8 + 8 with
       unequal valid frames: 3 DDP steps against one process's steps on
       the whole batch, the losses and grad norms within DDP_OF_CONTROL
       times a same-run control (the single process run twice: K2-90's
       dq atomics) and never tighter than DDP_FLOOR; each rank's counter
       shows K1-90 and K2-90 once per decoder layer and step;
   (b) cli/train.py --multihost under NCCL at world size 1 (with the CLIs
       of phase 5: 3 steps, rank 0's checkpoint, the synthesis CLI on
       it), and the DDP wrapper's wall and device ms per step beside the
       plain step's, in turn in one process (NCCL at world size 1);
   (c) K1-90 and K2-90 at sequence parallelism's per-rank shapes (T_q =
       1024 against T_k = 2048, k_len from 1024 to 2048) against their
       plain versions, rates 0 and 0.1, and the two halves' O against
       the whole sequence's; their ms beside their bounds;
   (d) the remat step with dropout 0.1 against the plain step on the same
       seeds (first loss equal, later losses and grad norms within the
       control's bound, the running statistics moved once a step, the
       own peak below the plain step's) and RAdam's first step (lr x the
       clipped gradient) and 6 more.
   The launches of its main paths ((a)'s ranks, (b)'s and (d)'s steps)
   are added to the kernels line's.
   In 5's and 18(b)'s conformer card-vs-CPU steps the same step runs
   again from the same weights through the plain masked attention
   (kernel counters 0): in 5 the fp32 update coverage must be at least
   COVERAGE_OF_CONTROL of that control's (18(b)'s keeps its 50 %), and
   in both the bf16 attention gradient norms within max(5 %,
   NORM_OF_CONTROL x the control's distance) of the CPU's fp32 and
   within KERNEL_VS_CONTROL of the control's own (flax's initial draw:
   see COVERAGE_OF_CONTROL).
22. the mel-to-mel post-processing line, run after 21 and before 7, at
   full width (the flagship's 6 + 6 layers, students of 6 layers, FFN
   kernel 5), random weights from seeds 22 and 23, on TRAIN_BATCH:
   (a) the frozen teacher (the flagship restored from a checkpoint the
       phase writes, eval, no gradients) and a v2 phone_embed student,
       bf16 amp, dropout 0.1: 3 warm-up and 10 timed steps, each launching
       6 K1-90 (the teacher), 6 K1-d-90 and 6 K2-90 (the student) and
       nothing else (ms, frames/s, own peak); the residual v3 student
       with the VQ likewise (5 steps; its EMA must move); one fp32 student
       step at dropout 0 on CPU_STEP_BATCH, card (the simple K1/K2)
       against CPU: the loss within 1e-4, every gradient within GRAD_TOL
       of its own max|g|;
   (b) the pregenerated route: the same student step on the teacher's
       mel and phone features (6 K1-d-90, 6 K2-90), its ms beside (a)'s;
   (c) the text-mel-mel v8 step with semantic_mask: 18 K1-d-90 and 18
       K2-90 a step;
   (d) a post_conformer student on the frozen teacher: 6 K1-90, 6
       K4-d-90, 6 K5-90 a step;
   (e) synthesize_integrate (18 K1-90 a call) and
       synthesize_fastspeech2_post (12 K1-90) at B=1 / 768 and B=8 / 2048
       frames, bf16: ms and RTF against RTF_LIMIT;
   (f) TTSEngine(post_model=) and the text-mel-mel engine (B=8, bucket
       128: 1024 frames): one call each, then each exported and its
       artifact run in a fresh process, bit for bit the engine's;
   (g) with the CLIs of phase 5: cli/teacher_forcing --save_phone, cli/
       train mel-mel on a frozen teacher and on the teacher_suffix corpus,
       cli/train text-mel-mel then cli/synthesize --save_prenet, and cli/
       synthesize --post_model.
   The launches of (a)-(f)'s main paths are added to the kernels line's;
   the fp32 check's are not.
23. tensor parallelism and the meshes, run after 22 and before 7, at full
   width (6 + 6 layers, 4 heads of 96) on TRAIN_BATCH, random weights
   from seed 23 (phase_tp):
   (a) the transformer flagship split over model = 2 (parallel/tp.py:
       each rank 2 heads and half the FFN channels) on two gloo ranks on
       the one card, bf16 amp, dropout 0.1, TP_STEPS steps on the whole
       batch, against one process on the same weights, batch and dropout
       streams, run twice (the second the same-run control): every
       logged term, the BatchNorm statistics' moves (equal on both
       ranks) and the gathered weights' updates within DDP_OF_CONTROL x
       the control's or the TP_* floors; each rank launching 6 K1-d-90
       and 6 K2-90 a step at (16, 2, 1024, 96), head offset 0 or 2, as
       one process does; the ranks' wall and profiled device ms a step
       beside one process's; an fp32 step (the simple K1-d, K2-dq,
       K2-dkdv at the head offsets) within TP_FP32_RTOL of one process's
       loss. Before them, in the main process: K1-d-90, K2-90, K4-d-90
       and K5-90 at (16, 2, 1024, 96) bf16 with head offset 2 of 4: each
       kernel's keep bits (read out with q = k = 0 and a one-hot v or dO
       over 96-key windows) bit for bit the whole-head mask's slice, a
       planted fault (head offset 0) caught, and each kernel against its
       plain version on random inputs at 2e-2 of max|ref|;
   (b) the conformer flagship likewise (6 K4-d-90, 6 K5-90 a step);
   (c) four gloo ranks on the card, the transformer flagship at dropout
       0: the (data 2, model 2) mesh (8 rows a rank) and the (dcn 2,
       data 2) multislice mesh (4 rows a rank), each against one process
       on the whole batch as in (a), the multislice DDP hook's dcn
       all-reduce carrying half of the gradient's elements;
   (d) cli/flash_ab.py fwd, bwd and drop at (32, 4, 1024, 96) bf16:
       kernel, plain and SDPA device ms.
   The launches of the ranks' main paths (a)-(c) are added to the
   kernels line's.

It then prints the phases' wall times, the engine calls' launch counts,
the kernels line (JSON), the nvidia-smi line, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3
HOP_SECONDS = 256 / 22050     # one mel frame of audio
DEVICE = "cuda"
FLAGSHIP = {}                 # HParams overrides; empty = the defaults
# the depth of phases 15 and 17-19 (GST, serving, conditioning, the other
# families): fewer layers than the flagships' 6 + 6, for the run's time;
# phases 3-14, 16, 20 and 21 run the flagships at full depth
LATER_DEPTH = dict(n_layer_encoder=3, n_layer_decoder=3)
# the two flagships: HParams overrides of the stacks, and the kernel that
# carries each one's decoder attention
PATHS = {
    "transformer": ({}, "K1-90"),
    "conformer": ({"encoder_type": "conformer",
                   "decoder_type": "conformer"}, "K4-90"),
}
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(ok: bool, msg: str):
    if not ok:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(fn, reps: int, warmup: int = 0) -> tuple:
    """(median host-clock ms of ``reps`` calls of ``fn`` after ``warmup``,
    the first timed call's output); each call ends in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    walls, first = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        first = out if first is None else first
    return statistics.median(walls), first


# a spin of ~2.5 ms at the H100's clock: the host enqueues the timed work
# meanwhile, so the events around it time the device alone
HOLD_CYCLES = 5_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up.
    Before each, a spin kernel (``torch.cuda._sleep``) holds the stream
    while the host enqueues ``fn``'s launches: the events time the
    device's work, not the host's launch latency, which a kernel of
    ~0.1 ms would not hide."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def simple_flash_attention(q, k, v, k_len, *, sm_scale, dropout_rate=0.0,
                           dropout_seed=0, causal=False):
    """K1/K1-d (with ``causal`` K3-f/K3-d) on the simple design
    (csrc/flash_attention_fwd.cu) in every mode, the bf16 main paths'
    included: the baseline of the same-run A/B against the Hopper design.
    Counts on ``flash_attention.launches`` and ``.dropout_launches`` (with
    ``causal`` ``.causal_launches`` and ``.causal_dropout_launches``)."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    return fa._forward(q, k, v, k_len, sm_scale, dropout_rate, dropout_seed,
                       causal, design="simple")


def simple_flash_relpos_attention(q_u, q_v, k, v, p, k_len, *, sm_scale,
                                  dropout_rate=0.0, dropout_seed=0):
    """K4/K4-d on the simple design (csrc/flash_relpos_fwd.cu) in every
    mode, the bf16 main paths' included: the baseline of the same-run A/B
    against the Hopper design. Counts on ``flash_relpos_attention.launches``
    and ``.dropout_launches``."""
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    return fr._forward(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate,
                       dropout_seed, design="simple")


def kernels():
    """Id -> (call, plain version, the kernel's name, source, TPU kernel it
    replaces, (object, attribute) of its launch count). K1 and K4 are the
    simple design, which the main paths no longer take in bf16; K1-90 and
    K4-90 the Hopper design that they take (``flash_attention`` and
    ``flash_relpos_attention``, the names the models call in
    ops/attention.py)."""
    from transformer_tts_tpu_torch.ops import flash_attention as k1
    from transformer_tts_tpu_torch.ops import flash_relpos as k4
    jax_k1 = "transformer_tts_tpu/ops/flash_attention.py:90"
    return {
        "K1": (simple_flash_attention, k1.flash_attention_fwd_reference,
               k1.KERNEL, "transformer_tts_tpu_torch/csrc/"
               "flash_attention_fwd.cu", jax_k1,
               (k1.flash_attention, "launches")),
        "K1-90": (k1.flash_attention, k1.flash_attention_fwd_reference,
                  k1.SM90_KERNEL, "transformer_tts_tpu_torch/csrc/"
                  "flash_fwd_sm90.cu", jax_k1,
                  (k1.flash_attention, "sm90_launches")),
        "K4": (simple_flash_relpos_attention,
               k4.flash_relpos_attention_fwd_reference, k4.KERNEL,
               "transformer_tts_tpu_torch/csrc/flash_relpos_fwd.cu",
               "transformer_tts_tpu/ops/flash_relpos.py:212",
               (k4.flash_relpos_attention, "launches")),
        "K4-90": (k4.flash_relpos_attention,
                  k4.flash_relpos_attention_fwd_reference, k4.SM90_KERNEL,
                  "transformer_tts_tpu_torch/csrc/flash_relpos_fwd_sm90.cu",
                  "transformer_tts_tpu/ops/flash_relpos.py:212",
                  (k4.flash_relpos_attention, "sm90_launches")),
    }


def train_kernels():
    """Id -> (object holding the launch count, its attribute, the entry's
    name in the kernels line, source, TPU kernel it replaces) for the
    kernels of the training path."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    fwd = "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd = "transformer_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd90 = "transformer_tts_tpu_torch/csrc/flash_fwd_sm90.cu"
    bwd90 = "transformer_tts_tpu_torch/csrc/flash_bwd_sm90.cu"
    rp_fwd = "transformer_tts_tpu_torch/csrc/flash_relpos_fwd.cu"
    rp_bwd = "transformer_tts_tpu_torch/csrc/flash_relpos_bwd.cu"
    rp_fwd90 = "transformer_tts_tpu_torch/csrc/flash_relpos_fwd_sm90.cu"
    rp_bwd90 = "transformer_tts_tpu_torch/csrc/flash_relpos_bwd_sm90.cu"
    jax_fa = "transformer_tts_tpu/ops/flash_attention.py"
    jax_rp = "transformer_tts_tpu/ops/flash_relpos.py"
    return {
        # the FastSpeech 2 step's kernels: the Hopper design, then the
        # simple one (the A/B's baseline; the fp32 card-vs-CPU step's)
        "K1-d-90": (fa.flash_attention, "sm90_dropout_launches",
                    "flash_fwd_sm90 dropout", fwd90, f"{jax_fa}:90"),
        "K2-90": (fa.flash_attention_bwd_sm90, "launches",
                  "flash_bwd_sm90 (dq, dk, dv fused)", bwd90,
                  f"{jax_fa}:266"),
        "K1-d": (fa.flash_attention, "dropout_launches",
                 "flash_attention_fwd dropout", fwd, f"{jax_fa}:90"),
        "K2-dq": (fa.flash_attention_bwd_dq, "launches",
                  "flash_attention_bwd dq", bwd, f"{jax_fa}:266"),
        "K2-dkdv": (fa.flash_attention_bwd_dkdv, "launches",
                    "flash_attention_bwd dk/dv", bwd, f"{jax_fa}:344"),
        # K3, the causal mode of the same kernels (the AR decoder): the
        # Hopper design the AR paths run in bf16, then the simple one (the
        # A/B's baseline; the fp32 card-vs-CPU step's)
        "K3-f-90": (fa.flash_attention, "sm90_causal_launches",
                    "flash_fwd_sm90 causal", fwd90, f"{jax_fa}:90"),
        "K3-d-90": (fa.flash_attention, "sm90_causal_dropout_launches",
                    "flash_fwd_sm90 causal dropout", fwd90, f"{jax_fa}:90"),
        "K3-90": (fa.flash_attention_bwd_sm90, "causal_launches",
                  "flash_bwd_sm90 causal (dq, dk, dv fused)", bwd90,
                  f"{jax_fa}:266"),
        "K3-f": (fa.flash_attention, "causal_launches",
                 "flash_attention_fwd causal", fwd, f"{jax_fa}:138"),
        "K3-d": (fa.flash_attention, "causal_dropout_launches",
                 "flash_attention_fwd causal dropout", fwd, f"{jax_fa}:138"),
        "K3-dq": (fa.flash_attention_bwd_dq, "causal_launches",
                  "flash_attention_bwd causal dq", bwd, f"{jax_fa}:306"),
        "K3-dkdv": (fa.flash_attention_bwd_dkdv, "causal_launches",
                    "flash_attention_bwd causal dk/dv", bwd,
                    f"{jax_fa}:379"),
        # the conformer decoder: K4 with dropout, and its backward K5, on
        # the Hopper design it runs in bf16 (the fused K5-90: the TPU's
        # _fused_bwd_kernel, _dq_kernel and _dkdv_kernel in one), then on
        # the simple one (the A/B's baseline; the fp32 card-vs-CPU step's)
        "K4-d-90": (fr.flash_relpos_attention, "sm90_dropout_launches",
                    "flash_relpos_fwd_sm90 dropout", rp_fwd90,
                    f"{jax_rp}:212"),
        "K5-90": (fr.flash_relpos_attention_bwd_sm90, "launches",
                  "flash_relpos_bwd_sm90 (dq_u, dq_v, dk, dv, dP fused)",
                  rp_bwd90, f"{jax_rp}:510"),
        "K4-d": (fr.flash_relpos_attention, "dropout_launches",
                 "flash_relpos_fwd dropout", rp_fwd, f"{jax_rp}:212"),
        "K5-dq": (fr.flash_relpos_attention_bwd_dq, "launches",
                  "flash_relpos_bwd dq", rp_bwd, f"{jax_rp}:360"),
        "K5-dkdv": (fr.flash_relpos_attention_bwd_dkdv, "launches",
                    "flash_relpos_bwd dk/dv/dP", rp_bwd, f"{jax_rp}:431"),
    }


def bias_kernels():
    """Id -> (object holding the launch count, its attribute, the entry's
    name in the kernels line, source, TPU kernel it replaces) for K6, the
    additive-bias mode of K1's and K2's sources, which no model path runs:
    chip_smoke drives it on the conformer's route that builds the relative
    bias in device memory (phase 7's route A/B). The Hopper design's K6-90,
    K6-d-90 and fused K6-bwd-90 run that route in bf16; the simple design's
    K6, K6-d, K6-dq and K6-dkdv run fp32 and the same-run A/B."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    fwd = "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd = "transformer_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd90 = "transformer_tts_tpu_torch/csrc/flash_fwd_sm90.cu"
    bwd90 = "transformer_tts_tpu_torch/csrc/flash_bwd_sm90.cu"
    jax_fa = "transformer_tts_tpu/ops/flash_attention.py"
    return {
        "K6-90": (fa.flash_attention_with_bias, "sm90_launches",
                  "flash_fwd_sm90 bias", fwd90, f"{jax_fa}:132"),
        "K6-d-90": (fa.flash_attention_with_bias, "sm90_dropout_launches",
                    "flash_fwd_sm90 bias dropout", fwd90, f"{jax_fa}:132"),
        "K6-bwd-90": (fa.flash_attention_bwd_sm90, "bias_launches",
                      "flash_bwd_sm90 bias (dq, dk, dv, dbias fused)", bwd90,
                      f"{jax_fa}:323"),
        "K6": (fa.flash_attention_with_bias, "launches",
               "flash_attention_fwd bias", fwd, f"{jax_fa}:132"),
        "K6-d": (fa.flash_attention_with_bias, "dropout_launches",
                 "flash_attention_fwd bias dropout", fwd, f"{jax_fa}:132"),
        "K6-dq": (fa.flash_attention_bwd_dq, "bias_launches",
                  "flash_attention_bwd dq+dbias", bwd, f"{jax_fa}:323"),
        "K6-dkdv": (fa.flash_attention_bwd_dkdv, "bias_launches",
                    "flash_attention_bwd bias dk/dv", bwd, f"{jax_fa}:374"),
    }


def counters() -> dict:
    """Id -> (object, attribute) of every kernel's launch count."""
    out = {kid: entry[5] for kid, entry in kernels().items()}
    out.update({kid: entry[:2] for kid, entry in train_kernels().items()})
    out.update({kid: entry[:2] for kid, entry in bias_kernels().items()})
    return out


def read_counts() -> dict:
    return {kid: getattr(obj, attr) for kid, (obj, attr) in counters().items()}


def set_counts(values: dict):
    for kid, (obj, attr) in counters().items():
        setattr(obj, attr, values.get(kid, 0))


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """Least time for the work: the larger of its operations over the
    peak rate and its bytes over HBM's rate."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kernel_bound_ms(kid, tensors, k_len) -> tuple:
    """K1: 4*H*T_q*sum_b(k_len[b])*d operations, q, k, v, o moved once;
    K4: 6*H*T*sum_b(k_len[b])*d operations (q_u.K^T, q_v.P^T, P.V), q_u,
    q_v, k, v, o and p moved once; both also lse and k_len."""
    relpos = kid.startswith("K4")
    q, k = tensors[0], tensors[2 if relpos else 1]
    b, h, t_q, d = q.shape
    keys = k_len.clamp(max=k.shape[2]).double().sum().item()
    per_key = 6.0 if relpos else 4.0
    moved = sum(x.numel() for x in tensors) + q.numel()     # inputs, o
    nbytes = moved * q.element_size() + b * h * t_q * 4 + k_len.numel() * 4
    return bound_ms(per_key * h * t_q * keys * d, nbytes, q.dtype)


# ---- phase 3: the kernels against their plain versions ----------------------

def kernel_errors(kid, tensors, k_len):
    """(err_o, err_lse) of the kernel against the fp32 plain version on the
    same inputs; fails unless rows with no valid key are exactly 0 and a
    second launch gives O bit for bit."""
    from transformer_tts_tpu_torch.ops.flash_attention import NEG_INF
    kernel, plain = kernels()[kid][:2]
    obj, attr = kernels()[kid][5]
    before = getattr(obj, attr)
    sm_scale = tensors[0].shape[-1] ** -0.5
    o, lse = kernel(*tensors, k_len, sm_scale=sm_scale)
    again, _ = kernel(*tensors, k_len, sm_scale=sm_scale)
    torch.cuda.synchronize()
    check(getattr(obj, attr) - before == 2,
          f"{kid}: the launches went to another kernel than {kid}'s")
    check(torch.equal(o, again), f"{kid}: a second launch gave another O")
    ro, rlse = plain(*(x.float() for x in tensors), k_len, sm_scale)
    empty = (k_len == 0)
    check(bool((o[empty] == 0).all()) and
          bool((lse[empty] == np.float32(NEG_INF)).all()),
          f"{kid}: rows with no valid key are not exactly 0 / -1e30")
    valid = ~empty
    err_o = (o.float() - ro)[valid].abs().max().item()
    err_lse = (lse - rlse)[valid].abs().max().item()
    return err_o, err_lse


def kernel_inputs(kid, gen, b, h, t_q, t_k, d):
    """Random inputs of the kernel's shapes, on the card, in fp32."""
    if not kid.startswith("K4"):
        shapes = [(b, h, t_q, d), (b, h, t_k, d), (b, h, t_k, d)]
    else:                               # q_u, q_v, k, v, p
        shapes = [(b, h, t_q, d)] * 4 + [(h, t_q, d)]
    return [torch.randn(s, generator=gen).to(DEVICE) for s in shapes]


def phase_kernel_vs_plain(gen):
    k1_cases = [(1, 4, 768, 768, 96, [768]),
                (8, 4, 2048, 2048, 96, [2048, 0, 1000, 1, 2047, 64, 65,
                                        1500]),
                (2, 4, 1000, 1000, 96, [1000, 333]),        # ragged T
                (2, 4, 300, 700, 96, [700, 0])]             # T_q != T_k
    k4_cases = [(1, 4, 768, 768, 96, [768]),
                (8, 4, 2048, 2048, 96, [2048, 0, 1, 64, 65, 2047, 1000,
                                        1500]),
                (2, 4, 1000, 1000, 96, [1000, 333]),        # ragged T
                (2, 4, 257, 257, 96, [257, 3])]             # just over 256
    cases = {  # (B, H, T_q, T_k, d, k_len)
        "K1": k1_cases,
        # the Hopper design takes bf16 only (fp32 goes to K1), and d = 64
        "K1-90": k1_cases + [(2, 4, 257, 257, 64, [257, 3])],
        "K4": k4_cases,
        "K4-90": k4_cases + [(2, 4, 511, 511, 64, [511, 65])],
    }
    for kid, kid_cases in cases.items():
        for b, h, t_q, t_k, d, k_len in kid_cases:
            tensors = kernel_inputs(kid, gen, b, h, t_q, t_k, d)
            kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
            for dtype, (tol_o, tol_lse) in TOLS.items():
                if kid.endswith("-90") and dtype != torch.bfloat16:
                    continue
                err_o, err_lse = kernel_errors(
                    kid, [x.to(dtype) for x in tensors], kl)
                print(f"{kid} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} k_len={k_len}: max|dO|={err_o:.3g} "
                      f"(tol {tol_o}) max|dlse|={err_lse:.3g} "
                      f"(tol {tol_lse})")
                check(err_o <= tol_o and err_lse <= tol_lse,
                      f"{kid} disagrees with its plain version at "
                      f"{(b, h, t_q, d)} {dtype}")
        for b, t in ((1, 768), (8, 2048)):     # the synthesis shapes
            tensors = [x.to(torch.bfloat16)
                       for x in kernel_inputs(kid, gen, b, 4, t, t, 96)]
            res = kernel_timings(kid, tensors, torch.full(
                (b,), t, dtype=torch.int32, device=DEVICE))
            print(f"{kid} ({b},4,{t},96) bf16 all keys: kernel "
                  f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
                  f"library {res['library_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']})")


# ---- phase 3, continued: the training kernels -------------------------------

DROPOUT_SEED = -123456789       # an int32 whose uint32 bits wrap
# fp32: products in FMAs, sums in another order; bf16: dS and P keep
# rounded to bf16 before their products, as the TPU kernels do
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def max_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|) in fp32."""
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def train_kernel_ids(design: str, causal: bool, rate: float) -> tuple:
    """(forward id, backward ids) of the kernels a design runs for a mode:
    the Hopper design's K1/K1-d (K3-f/K3-d) and fused K2 (K3's), or the
    simple design's forward and its dq and dk/dv pair."""
    if design == "sm90":
        if causal:
            return ("K3-d-90" if rate else "K3-f-90"), ("K3-90",)
        return ("K1-d-90" if rate else "K1-90"), ("K2-90",)
    if causal:
        return ("K3-d" if rate else "K3-f"), ("K3-dq", "K3-dkdv")
    return ("K1-d" if rate else "K1"), ("K2-dq", "K2-dkdv")


def check_train_kernels(q, k, v, do, k_len, rate, seed=DROPOUT_SEED,
                        label="", causal=False, design=None) -> tuple:
    """K1/K1-d and K2 (with ``causal`` K3's forward and backward) on
    (q, k, v, do) against the plain versions in fp32 on the same inputs,
    on the design ``flash_attention`` picks for the mode, or with
    ``design="simple"`` on the simple kernels (the A/B's baseline); the
    launches must have gone to that design's kernels for the mode (the
    forward twice, each backward kernel once), and a second forward launch
    must give O bit for bit. O, dq, dk and dv must agree within REL_TOL
    times that tensor's own max |ref| (the gradients reaching the
    decoder's attention in training are ~1e-7), lse within TOLS' absolute
    limit; dk and dv exactly 0 for keys at or past k_len. Returns ({name:
    max abs err}, {name: max |ref|}, o). Launch counts are left as they
    were."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    chosen = design or fa.select_design(q.dtype, False, q.shape[-1])
    fwd, bwd_ids = train_kernel_ids(chosen, causal, rate)
    bwd = "/".join(bwd_ids)
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
              causal=causal)
    with torch.no_grad():
        if design == "simple":
            forward = partial(simple_flash_attention, q, k, v, k_len,
                              sm_scale=sm_scale, dropout_rate=rate,
                              dropout_seed=seed, causal=causal)
            o, lse = forward()
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, do, lse, delta, k_len)
            grads = (fa.flash_attention_bwd_dq(*args, **kw),
                     *fa.flash_attention_bwd_dkdv(*args, **kw))
        else:
            forward = partial(fa.flash_attention, q, k, v, k_len,
                              dropout_rate=rate, dropout_seed=seed,
                              causal=causal)
            o, lse = forward()
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, k_len, **kw)
        again, _ = forward()
        torch.cuda.synchronize()
        check(torch.equal(o, again), f"{fwd}{label}: a second launch gave "
                                     f"another O")
        moved = {kid: n - counts[kid] for kid, n in read_counts().items()
                 if n != counts[kid]}
        want = {fwd: 2, **{kid: 1 for kid in bwd_ids}}
        check(moved == want, f"{fwd}/{bwd}{label}: launches {moved}, "
                             f"not {want}")
        f = [x.float() for x in (q, k, v)]
        ro, rlse = fa.flash_attention_fwd_reference(*f, k_len, sm_scale,
                                                    rate, seed, causal)
        ref = fa.flash_attention_bwd_reference(*f, o.float(), lse,
                                               do.float(), k_len, sm_scale,
                                               rate, seed, causal)
    set_counts(counts)
    empty = k_len == 0
    check(bool((o[empty] == 0).all()), f"{fwd}{label}: a row with no valid "
                                       f"key is not 0")
    errs, peaks = {}, {}
    errs["o"], peaks["o"] = max_err(o[~empty], ro[~empty])
    errs["lse"], peaks["lse"] = max_err(lse[~empty], rlse[~empty])
    rel = REL_TOL[q.dtype]
    check(errs["o"] <= rel * peaks["o"] and errs["lse"] <= TOLS[q.dtype][1],
          f"{fwd}{label} disagrees with its plain version: {errs} against "
          f"max|ref| {peaks}")
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        errs[name], peaks[name] = max_err(got, want)
        check(errs[name] <= rel * peaks[name],
              f"{bwd} {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    for name, g in (("dk", grads[1]), ("dv", grads[2])):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b, :, n:] == 0).all()),
                  f"{bwd} {name}{label} is not exactly 0 for keys at or "
                  f"past k_len")
    return errs, peaks, o


def phase_train_kernels_vs_plain(gen, train_k_len):
    """K1-d and K2 against their plain versions: k_len in {0, 1, 65, T},
    ragged T = 1000, T_q = 300 != T_k = 700, and the train step's shape
    (16, 4, 1024, 96) with k_len in {0, 1, 65, T}, with T_q = 768 != T_k,
    and with its batch's mel lengths as k_len; fp32 (TF32 off, the simple
    kernels) and bf16 (the Hopper design, then the simple one); dropout 0
    and 0.1 on the same seed."""
    b_train, _, t_train, _ = TRAIN_BATCH
    edge = [t_train, 0, 1, 65] * (b_train // 4)
    cases = [(4, 4, 1000, 1000, 96, [1000, 0, 1, 65]),
             (2, 4, 300, 700, 96, [700, 65]),
             (b_train, 4, t_train, t_train, 96, edge),
             (b_train, 4, 768, t_train, 96, edge),
             (b_train, 4, t_train, t_train, 96, train_k_len.tolist())]
    for b, h, t_q, t_k, d, k_len in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        for dtype, design in ((torch.float32, None), (torch.bfloat16, None),
                              (torch.bfloat16, "simple")):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_train_kernels(
                    *(x.to(dtype) for x in (q, k, v, do)), kl, rate,
                    design=design)
                name = ("K1-d/K2 simple" if dtype == torch.float32
                        or design else "K1-d/K2 sm90")
                print(f"{name} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len="
                      f"{k_len if len(set(k_len)) <= 4 else 'the train batch'}"
                      ": " + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                      f"{peaks[n]:.3g})"
                                      for n, e in errs.items()))


AR_GROUPS = 511                 # decoder groups at the 1024-frame bucket


def phase_causal_kernels_vs_plain(gen, ar_k_len):
    """K3 (the causal forward at rates 0 and 0.1, its dq and dk/dv)
    against its plain versions: (16, 4, 511, 96), the AR train step's
    shape, with k_len in {T, 0, 1, 65} and the rest of the rows the AR
    batch's decoder groups; T_q != T_k both ways; d = 64; fp32 (TF32 off,
    the simple kernels) and bf16 on both designs (the Hopper one, K3-f-90
    or K3-d-90 and the fused K3-90, then the simple one), O, dq, dk and
    dv each within REL_TOL of its own max|ref|, lse as K1's; dk and dv
    exactly 0 past k_len; O bit for bit on a second launch; each launch
    on its id's counter."""
    b_train = TRAIN_BATCH[0]
    k_len = ([AR_GROUPS, 0, 1, 65] + ar_k_len.tolist())[:b_train]
    cases = [(b_train, 4, AR_GROUPS, AR_GROUPS, 96, k_len),
             (2, 4, 300, 700, 96, [700, 65]),
             (2, 4, 700, 300, 96, [300, 1]),
             (4, 4, 300, 300, 64, [300, 0, 1, 65])]
    for b, h, t_q, t_k, d, kl in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        kl = torch.tensor(kl, dtype=torch.int32, device=DEVICE)
        for dtype, design in ((torch.float32, None), (torch.bfloat16, None),
                              (torch.bfloat16, "simple")):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_train_kernels(
                    *(x.to(dtype) for x in (q, k, v, do)), kl, rate,
                    causal=True, design=design)
                name = ("K3 simple" if dtype == torch.float32 or design
                        else "K3 sm90")
                cases_k = (kl.tolist() if b <= 4
                           else "T, 0, 1, 65 and the AR batch's")
                print(f"{name} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len={cases_k}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


RELPOS_GRADS = ("dq_u", "dq_v", "dk", "dv", "dp")


def relpos_kernel_ids(design: str, rate: float) -> tuple:
    """(forward id, backward ids) of the relative kernels a design runs:
    the Hopper design's K4-90/K4-d-90 and fused K5-90, or the simple
    design's K4/K4-d and its dq and dk/dv/dP pair."""
    if design == "sm90":
        return ("K4-d-90" if rate else "K4-90"), ("K5-90",)
    return ("K4-d" if rate else "K4"), ("K5-dq", "K5-dkdv")


def check_relpos_train_kernels(q_u, q_v, k, v, p, do, k_len, rate,
                               seed=DROPOUT_SEED, label="",
                               design=None) -> tuple:
    """K4 (rate 0) or K4-d and K5 on (q_u, q_v, k, v, p, do) against their
    plain versions in fp32 on the same inputs, on the design
    ``flash_relpos_attention`` picks for the mode, or with
    ``design="simple"`` on the simple kernels (the A/B's baseline): the
    launches must have gone to that design's kernels (the forward twice,
    each backward kernel once); O, dq_u, dq_v, dk, dv and dp each within
    REL_TOL of its own max|ref|, lse within TOLS' absolute limit; dk and
    dv exactly 0 for keys at or past k_len; O bit for bit the same on a
    second call with the same seed. Returns ({name: max abs err}, {name:
    max|ref|}, o). Launch counts are left as they were."""
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    chosen = design or fr._design(q_u, q_v, k, v, p, (do,))
    fwd, bwd_ids = relpos_kernel_ids(chosen, rate)
    bwd = "/".join(bwd_ids)
    counts = read_counts()
    sm_scale = q_u.shape[-1] ** -0.5
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    call = (partial(simple_flash_relpos_attention, sm_scale=sm_scale)
            if design == "simple" else fr.flash_relpos_attention)
    with torch.no_grad():
        o, lse = call(q_u, q_v, k, v, p, k_len, **kw)
        o_again, _ = call(q_u, q_v, k, v, p, k_len, **kw)
        grads = fr.flash_relpos_attention_bwd(q_u, q_v, k, v, p, o, lse, do,
                                              k_len, sm_scale=sm_scale,
                                              design=design, **kw)
        torch.cuda.synchronize()
        moved = {kid: n - counts[kid] for kid, n in read_counts().items()
                 if n != counts[kid]}
        want = {fwd: 2, **{kid: 1 for kid in bwd_ids}}
        check(moved == want, f"{fwd}/{bwd}{label}: launches {moved}, not "
                             f"{want}")
        f = [x.float() for x in (q_u, q_v, k, v, p)]
        ro, rlse = fr.flash_relpos_attention_fwd_reference(
            *f, k_len, sm_scale, rate, seed)
        ref = fr.flash_relpos_attention_bwd_reference(
            *f, o.float(), lse, do.float(), k_len, sm_scale, rate, seed)
    set_counts(counts)
    check(torch.equal(o, o_again), f"{fwd}{label}: another O on a second "
                                   f"call with the same seed")
    empty = k_len == 0
    check(bool((o[empty] == 0).all()), f"{fwd}{label}: a row with no valid "
                                       f"key is not 0")
    errs, peaks = {}, {}
    errs["o"], peaks["o"] = max_err(o[~empty], ro[~empty])
    errs["lse"], peaks["lse"] = max_err(lse[~empty], rlse[~empty])
    rel = REL_TOL[q_u.dtype]
    check(errs["o"] <= rel * peaks["o"] and errs["lse"] <= TOLS[q_u.dtype][1],
          f"{fwd}{label} disagrees with its plain version: {errs} against "
          f"max|ref| {peaks}")
    for name, got, want in zip(RELPOS_GRADS, grads, ref):
        errs[name], peaks[name] = max_err(got, want)
        check(errs[name] <= rel * peaks[name],
              f"{bwd} {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    for name, g in (("dk", grads[2]), ("dv", grads[3])):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b, :, n:] == 0).all()),
                  f"{bwd} {name}{label} is not exactly 0 for keys at or "
                  f"past k_len")
    return errs, peaks, o


RELPOS_T = (1024, 1000, 511)    # E's window alignment depends on T mod 64


def phase_relpos_kernels_vs_plain(gen, train_k_len):
    """K4/K4-d and K5 against their plain versions: k_len in {0, 1, 65, T}
    at T in RELPOS_T and d in {64, 96}, in bf16 on both designs (the
    Hopper one, K4-90 or K4-d-90 and the fused K5-90, then the simple
    one); at T = 1000, d = 96 also fp32 (TF32 off, the simple kernels);
    and the conformer train step's shape (16, 4, 1024, 96) with its
    batch's mel lengths as k_len in fp32 and on both bf16 designs;
    dropout 0 and 0.1 on the same seed."""
    b_train, _, t_train, _ = TRAIN_BATCH
    cases = [(4, 4, t, d, [t, 0, 1, 65]) for t in RELPOS_T for d in (96, 64)]
    cases.append((b_train, 4, t_train, 96, train_k_len.tolist()))
    for b, h, t, d, k_len in cases:
        q_u, q_v, k, v, do = (torch.randn(b, h, t, d, generator=gen)
                              .to(DEVICE) for _ in range(5))
        p = torch.randn(h, t, d, generator=gen).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        modes = [(torch.bfloat16, None), (torch.bfloat16, "simple")]
        if (t, d) == (1000, 96) or b > 4:
            modes.insert(0, (torch.float32, None))
        for dtype, design in modes:
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_relpos_train_kernels(
                    *(x.to(dtype) for x in (q_u, q_v, k, v, p, do)), kl,
                    rate, design=design)
                name = ("K4/K5 simple" if dtype == torch.float32 or design
                        else "K4/K5 sm90")
                print(f"{name} vs plain ({b},{h},{t},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len="
                      f"{k_len if b <= 4 else 'the train batch'}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


BIAS_GRADS = ("dq", "dk", "dv", "dbias")


def bias_kernel_ids(design: str, rate: float) -> tuple:
    """(forward id, backward ids) of the K6 kernels a design runs: the
    Hopper design's K6-90/K6-d-90 and fused K6-bwd-90, or the simple
    design's K6/K6-d and its dq+dbias and dk/dv pair."""
    if design == "sm90":
        return ("K6-d-90" if rate else "K6-90"), ("K6-bwd-90",)
    return ("K6-d" if rate else "K6"), ("K6-dq", "K6-dkdv")


def check_bias_kernels(q, k, v, bias, do, k_len, rate, seed=DROPOUT_SEED,
                       label="", design=None) -> tuple:
    """K6 (rate 0) or K6-d and K6's backward on (q, k, v, bias, do) against
    their plain versions in fp32 on the same inputs, on the design
    ``flash_attention_with_bias`` picks for the mode, or with
    ``design="simple"`` on the simple kernels (the A/B's baseline): the
    forward and the backward each run twice, and the launches must have
    gone to that design's kernels. O, dq, dk, dv and dbias each within
    REL_TOL of its own max|ref|, lse within TOLS' absolute limit; dbias,
    dk and dv exactly 0 for keys at or past k_len (dbias on every row); O,
    dk, dv and dbias bit for bit the same on the second call with the same
    seed (dq sums with atomics in the Hopper design). Returns ({name: max
    abs err}, {name: max|ref|}, o). Launch counts are left as they
    were."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    chosen = design or fa._design(q, k, v, bias, (do,))
    fwd, bwd_ids = bias_kernel_ids(chosen, rate)
    bwd = "/".join(bwd_ids)
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    bkw = dict(sm_scale=sm_scale, bias=bias, **kw)
    with torch.no_grad():
        if design == "simple":
            forward = partial(fa._forward, q, k, v, k_len, sm_scale, rate,
                              seed, False, bias, design="simple")
        else:
            forward = partial(fa.flash_attention_with_bias, q, k, v, bias,
                              k_len, **kw)
        o, lse = forward()
        o_again, _ = forward()
        if design == "simple":
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, do, lse, delta, k_len)

            def backward():
                dq, dbias = fa.flash_attention_bwd_dq(*args, **bkw)
                return (dq, *fa.flash_attention_bwd_dkdv(*args, **bkw),
                        dbias)
        else:
            backward = partial(fa.flash_attention_bwd, q, k, v, o, lse, do,
                               k_len, **bkw)
        grads = backward()
        again = backward()
        torch.cuda.synchronize()
        moved = {kid: n - counts[kid] for kid, n in read_counts().items()
                 if n != counts[kid]}
        want = {fwd: 2, **{kid: 2 for kid in bwd_ids}}
        check(moved == want, f"{fwd}/{bwd}{label}: launches {moved}, not "
                             f"{want}")
        f = [x.float() for x in (q, k, v)]
        ro, rlse = fa.flash_attention_fwd_reference(
            *f, k_len, sm_scale, rate, seed, bias=bias.float())
        ref = fa.flash_attention_bwd_reference(
            *f, o.float(), lse, do.float(), k_len, sm_scale, rate, seed,
            bias=bias.float())
    set_counts(counts)
    check(torch.equal(o, o_again), f"{fwd}{label}: another O on a second "
                                   f"call with the same seed")
    for name, a, b in zip(BIAS_GRADS[1:], grads[1:], again[1:]):
        check(torch.equal(a, b), f"{bwd} {name}{label}: another result on "
                                 f"a second call")
    empty = k_len == 0
    check(bool((o[empty] == 0).all()), f"{fwd}{label}: a row with no valid "
                                       f"key is not 0")
    errs, peaks = {}, {}
    errs["o"], peaks["o"] = max_err(o[~empty], ro[~empty])
    errs["lse"], peaks["lse"] = max_err(lse[~empty], rlse[~empty])
    rel = REL_TOL[q.dtype]
    check(errs["o"] <= rel * peaks["o"] and errs["lse"] <= TOLS[q.dtype][1],
          f"{fwd}{label} disagrees with its plain version: {errs} against "
          f"max|ref| {peaks}")
    for name, got, want in zip(BIAS_GRADS, grads, ref):
        errs[name], peaks[name] = max_err(got, want)
        check(errs[name] <= rel * peaks[name],
              f"{bwd} {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    check(grads[3].dtype == bias.dtype, f"{bwd} dbias{label} is not in the "
                                        f"bias's dtype")
    for name, g, axis in (("dk", grads[1], 2), ("dv", grads[2], 2),
                          ("dbias", grads[3], 3)):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b].narrow(axis - 1, n, g.shape[axis] - n) == 0)
                       .all()),
                  f"{bwd} {name}{label} is not exactly 0 for keys at or past "
                  f"k_len")
    return errs, peaks, o


BIAS_T = (1000, 1024)   # a ragged last key tile, then none


def phase_bias_kernels_vs_plain(gen):
    """K6/K6-d and K6's backward against their plain versions: k_len in
    {0, 1, 65, T} at T = 1000 and 1024, d in {64, 96}, in bf16 on both
    designs (the Hopper one, K6-90 or K6-d-90 and the fused K6-bwd-90,
    then the simple one, K6 or K6-d and dq+dbias, dk/dv); at T = 1000, d =
    96 also fp32 (TF32 off, the simple kernels); and T_q = 300 != T_k =
    700, whose T_k is not a multiple of 8, so the rule sends bf16 to the
    simple kernels (which read its bias tiles element by element), fp32
    and bf16; dropout 0 and 0.1 on the same seed; a random bias of scale
    2."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    cases = [(4, 4, t, t, d, [t, 0, 1, 65]) for t in BIAS_T
             for d in (96, 64)]
    cases.append((2, 4, 300, 700, 96, [700, 65]))
    for b, h, t_q, t_k, d, k_len in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        bias = (2 * torch.randn(b, h, t_q, t_k, generator=gen)).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        rule = fa._design(*(x.to(torch.bfloat16) for x in (q, k, v)),
                          bias.to(torch.bfloat16))
        check(rule == ("sm90" if t_k % 8 == 0 else "simple"),
              f"the design rule sends a bf16 bias of T_k = {t_k} to {rule}")
        modes = [(torch.bfloat16, None)]
        if rule == "sm90":
            modes.append((torch.bfloat16, "simple"))
        if (t_q, d) == (BIAS_T[0], 96) or rule == "simple":
            modes.insert(0, (torch.float32, None))
        for dtype, design in modes:
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_bias_kernels(
                    *(x.to(dtype) for x in (q, k, v, bias, do)), kl, rate,
                    design=design)
                name = ("K6 sm90" if dtype == torch.bfloat16 and not design
                        and rule == "sm90" else "K6 simple")
                print(f"{name} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len={k_len}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


def relpos_bias(q_v, p, k_len, sm_scale):
    """rel_shift(q_v P^T) * sm_scale with -inf past k_len, in q_v's dtype:
    the additive mask of K4's library yardstick."""
    from transformer_tts_tpu_torch.ops.flash_relpos import rel_shift
    bias = rel_shift(torch.matmul(q_v, p.transpose(-1, -2))) * sm_scale
    valid = (torch.arange(q_v.shape[2], device=q_v.device)[None, :]
             < k_len[:, None])[:, None, None, :]
    return bias.masked_fill(~valid, float("-inf"))


def kernel_timings(kid, tensors, k_len) -> dict:
    """Kernel, plain version and library times on the same inputs, the
    bound and the kernel's error against the fp32 plain version. K1's
    library call is SDPA with the key mask; K4's is SDPA with the
    relative bias precomputed, whose build is timed apart (bias_ms)."""
    import torch.nn.functional as F
    kernel, plain = kernels()[kid][:2]
    sm_scale = tensors[0].shape[-1] ** -0.5
    counts = read_counts()
    res = {
        "ms": time_ms(lambda: kernel(*tensors, k_len, sm_scale=sm_scale)),
        "plain_ms": time_ms(lambda: plain(*tensors, k_len, sm_scale)),
    }
    if not kid.startswith("K4"):
        q, k, v = tensors
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                < k_len[:, None])[:, None, None, :]
    else:
        q, q_v, k, v, p = tensors
        mask = relpos_bias(q_v, p, k_len, sm_scale)
        res["bias_ms"] = time_ms(lambda: relpos_bias(q_v, p, k_len,
                                                     sm_scale))
    res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm_scale))
    res["bound_ms"], res["bound_by"] = kernel_bound_ms(kid, tensors, k_len)
    res["max_abs_err"] = kernel_errors(kid, tensors, k_len)[0]
    set_counts(counts)      # these launches are not the main path's
    return res


# ---- phase 4: the full-width slices -----------------------------------------

def flagship_model(device, amp: bool, stacks: dict, seed: int = 0):
    from transformer_tts_tpu_torch.config import HParams
    from transformer_tts_tpu_torch.models import build_model
    # d 384, 6+6 layers, 4 heads, vocab 152, mel 80
    hp = HParams(**dict(FLAGSHIP, **stacks, amp=amp))
    model = build_model(hp, device=device, seed=seed).eval()
    with torch.no_grad():
        # random weights then give ~6 frames per phone
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            math.log(1.0 + 6.0))
    return hp, model


def text_batch(gen, batch: int, length: int, min_len: int, vocab: int):
    lens = torch.linspace(length, min_len, batch).round().long()
    text = torch.randint(1, vocab, (batch, length), generator=gen)
    pos = torch.arange(1, length + 1)[None].repeat(batch, 1)
    pos = torch.where(pos <= lens[:, None], pos, torch.zeros_like(pos))
    return torch.where(pos > 0, text, torch.zeros_like(text)), pos


def phase_teacher_forced(gen, name, stacks):
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    hp, cpu_model = flagship_model("cpu", amp=False, stacks=stacks)
    text, pos = text_batch(gen, 2, 128, 100, hp.vocab_size)
    t = 768
    d = torch.randint(2, 8, text.shape, generator=gen) * (text != 0)
    p = torch.rand(2, t, generator=gen) * 740 + 60
    e = torch.rand(2, t, generator=gen) * 315
    inputs = (text, pad_mask(pos), t, d, p, e)

    with torch.no_grad():
        ref = cpu_model(*inputs)
    _, model = flagship_model(DEVICE, amp=False, stacks=stacks)
    cuda_inputs = [x.to(DEVICE) if torch.is_tensor(x) else x for x in inputs]
    for amp in (False, True):
        model.amp = amp
        with torch.no_grad():
            out = model(*cuda_inputs)
        check(torch.equal(out.mel_len.cpu(), ref.mel_len),
              f"{name} teacher-forced mel_len differs between card and CPU")
        errs = []
        for b, n in enumerate(ref.mel_len.tolist()):
            diff = out.mel_post[b, :n].float().cpu() - ref.mel_post[b, :n]
            errs.append(diff.abs().max().item())
        peak = ref.mel_post.abs().max().item()
        tol = 5e-2 * max(1.0, peak) if amp else 1e-3
        label = "bf16 amp" if amp else "fp32"
        print(f"{name} teacher-forced forward B=2 L=128 T={t}: card {label} "
              f"vs CPU fp32: max|d mel_post| = {max(errs):.3g} (tol "
              f"{tol:.3g}, max|ref| = {peak:.3g}, frames "
              f"{ref.mel_len.tolist()})")
        check(max(errs) <= tol, f"{name}: card {label} forward disagrees "
                                f"with CPU")


@contextmanager
def capture_calls(module, name: str, store: list):
    """Append (args, kwargs) of every call of ``module.name`` to ``store``,
    the tensors as detached copies; the call still goes to the real
    function, whose launches count."""
    real = getattr(module, name)

    def recording(*args, **kw):
        store.append((tuple(x.detach().clone() if torch.is_tensor(x) else x
                            for x in args), dict(kw)))
        return real(*args, **kw)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_synthesis(gen, name, stacks, kid):
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    from transformer_tts_tpu_torch.ops import attention
    hp, model = flagship_model(DEVICE, amp=True, stacks=stacks)
    cases = [(1, 768), (8, 2048)]
    batches = []
    for batch, max_frames in cases:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        batches.append((text.to(DEVICE), pos.to(DEVICE), max_frames))

    captured = []
    set_counts({})                          # the main path starts here
    per_call = {k: [] for k in counters()}
    with capture_calls(attention, kernels()[kid][0].__name__, captured):
        for text, pos, max_frames in batches:
            captured.clear()
            before = read_counts()
            mel, mel_len, dur = synthesize_fastspeech2(model, text, pos,
                                                       max_frames)
            torch.cuda.synchronize()
            for k, n in read_counts().items():
                per_call[k].append(n - before[k])
            check(mel.shape == (text.shape[0], max_frames, hp.mel_dim),
                  f"{name}: mel shape {tuple(mel.shape)}")
            check(bool(torch.isfinite(mel.float()).all()),
                  f"{name}: non-finite mel")
            check(int(mel_len.min()) > 0, f"{name}: empty mel_len")
    launches = read_counts()                # it ends here
    print(f"{name} main path: launches per synthesis call "
          f"{json.dumps(per_call)} (expect {hp.n_layer_decoder} of {kid} "
          f"each, none of the others), total {json.dumps(launches)}")
    check(all(n == hp.n_layer_decoder for n in per_call[kid]),
          f"{name}: {kid} did not launch once per decoder layer")
    check(all(n == 0 for k, n in launches.items() if k != kid),
          f"{name}: a kernel of another path launched")
    main_inputs = captured[0][0]    # the B=8 / 2048-frame call's layer 0

    for text, pos, max_frames in batches:
        ms, (_, mel_len, _) = wall_ms(
            lambda: synthesize_fastspeech2(model, text, pos, max_frames), 10,
            warmup=3)
        audio_s = mel_len.sum().item() * HOP_SECONDS
        rtf = ms / 1e3 / audio_s
        print(f"{name} synthesize_fastspeech2 B={text.shape[0]} L=128 "
              f"max_frames={max_frames} bf16 amp: {ms:.3f} ms/call "
              f"(median of 10), {mel_len.sum().item()} frames = "
              f"{audio_s:.3f} s audio, RTF {rtf:.6f}")
    return hp, model, launches, main_inputs


SYNTH_CLIS = {}                 # name -> what 4(c)'s synthesis CLI reads


def phase_cli(name, stacks, hp, model):
    """4(c): the flagship's checkpoint, hparams and a 3-line script for
    cli/synthesize.py, which runs with the other CLIs, all at once
    (``phase_clis``; ``check_synth_cli`` then reads what it wrote)."""
    from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
    work = os.path.join(WORK, name)
    model_dir = os.path.join(work, "model")
    out_dir = os.path.join(work, "generated")
    os.makedirs(model_dir, exist_ok=True)
    save_checkpoint(model, model_dir)
    script = os.path.join(work, "test.txt")
    rs = np.random.RandomState(0)
    lines = [" ".join(str(i) for i in rs.randint(1, hp.vocab_size, n))
             for n in (40, 90, 128)]
    with open(script, "w") as fh:
        fh.write("".join(f"utt{i}.npy|{s}\n" for i, s in enumerate(lines)))
    with open(os.path.join(model_dir, "hparams.py"), "w") as fh:
        for key, value in dict(FLAGSHIP, **stacks,
                               test_script=script).items():
            fh.write(f"{key} = {value!r}\n")
    SYNTH_CLIS[name] = dict(hp=hp, out_dir=out_dir, argv=[
        "transformer_tts_tpu_torch.cli.synthesize", "--load_name",
        model_dir, "--save", out_dir, "--max_frames", "2048", "--device",
        DEVICE])


def check_synth_cli(name, out: str):
    """What 4(c)'s synthesis CLI of ``name`` wrote: 3 finite mels, each
    as long as its alignment's frames."""
    c = SYNTH_CLIS.pop(name)
    print(out.strip())
    for i, n_text in enumerate((40, 90, 128)):
        mel = np.load(os.path.join(c["out_dir"], f"{i}.npy"))
        align = np.load(os.path.join(c["out_dir"], f"{i}_alignment.npy"))
        check(mel.dtype == np.float32 and mel.ndim == 2
              and mel.shape[1] == c["hp"].mel_dim
              and 0 < mel.shape[0] <= 2048
              and bool(np.isfinite(mel).all()),
              f"{name} CLI mel {i} {mel.shape}")
        check(mel.shape[0] == min(2048, int(align.sum()))
              and align.shape[0] >= n_text, f"{name} CLI alignment {i}")
    print(f"{name} CLI: 3 utterances written and checked")


# ---- the profile ------------------------------------------------------------

# CUPTI's own activity records, which are no work of the program
CUPTI_OVERHEAD = ("Lazy Function Loading", "Activity Buffer Request")
# profiles queued by the phases, run after every timed phase: a profiler
# pass slows the host work of the rest of its process (train_step_ab.py
# times steps before and after one), so no timing may follow one. Each
# holds the warm state its phase timed (a train state and its step, the AR
# model with its captured graphs), so none is built again; the card holds
# them meanwhile (a few GB, inside each "resident" line)
PROFILES = []


def print_profile(label: str, fn, n: int, ms_per_run: float):
    """Run ``fn`` ``n`` times under torch.profiler (the card's activity
    alone: the host's events, which nothing here reads, would make the
    trace's processing the cost) and print the ten device operations
    (kernels, copies, memsets) with the most self time on the card, each
    with its share of the device time and its launches per run; user
    annotations (whose device range covers kernels counted already) and
    CUPTI's overhead records are left out. The device's busy time per run
    stands against ``ms_per_run``, the same work's time measured without
    the profiler in this run, for the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and device_us(e) > 0
           and not getattr(e, "is_user_annotation", False)
           and e.key not in CUPTI_OVERHEAD]
    busy_ms = sum(device_us(e) for e in ops) / 1e3 / n
    check(busy_ms > 0, f"{label}: the profile holds no device time")
    print(f"profile of {label}, {n} run(s): device busy {busy_ms:.3f} ms "
          f"per run against {ms_per_run:.3f} ms measured without the "
          f"profiler ({max(0.0, 1 - busy_ms / ms_per_run):.1%} idle); top 10 "
          f"device operations (ms per run, share of device time, launches "
          f"per run):")
    for e in sorted(ops, key=device_us, reverse=True)[:10]:
        ms = device_us(e) / 1e3 / n
        print(f"  {ms:9.4f} ms {ms / busy_ms:6.1%} {e.count / n:8.1f}x "
              f"{e.key[:110]}")
    return ops


# ---- phase 5: training ------------------------------------------------------

TRAIN_BATCH = (16, 128, 1024, (600, 1000))   # B, text bucket, mel bucket,
                                             # range of frames per row
CPU_STEP_BATCH = (2, 128, 768, (500, 760))
CLI_CORPUS = (32, (300, 900), 8)             # utterances, frames, batch
# the loader threads of each training CLI: up to 14 CLIs run at once on
# the host's 8 cores, so each takes 2 (hp.num_workers defaults to 8)
CLI_WORKERS = 2


def train_batch(gen, hp, b, text_len, mel_len, frames, device):
    """A collated training batch: text lengths from text_len down to half
    of it, durations per row summing to a total drawn from ``frames``,
    random mel, f0 and energy on the valid frames, the collate's pads."""
    lens = torch.linspace(text_len, text_len // 2, b).round().long()
    text = torch.zeros(b, text_len, dtype=torch.int32)
    dur = torch.zeros(b, text_len, dtype=torch.int32)
    totals = torch.randint(frames[0], frames[1] + 1, (b,), generator=gen)
    for i, (n, total) in enumerate(zip(lens.tolist(), totals.tolist())):
        text[i, :n] = torch.randint(1, hp.vocab_size, (n,), generator=gen,
                                    dtype=torch.int32)
        w = torch.rand(n, generator=gen) + 0.5
        d = (w / w.sum() * total).floor().int()
        d[: total - int(d.sum())] += 1
        dur[i, :n] = d
    pos = torch.arange(1, text_len + 1)[None]
    pos_text = torch.where(text != 0, pos, 0).int()
    pos_mel = torch.where(torch.arange(1, mel_len + 1)[None]
                          <= totals[:, None],
                          torch.arange(1, mel_len + 1)[None], 0).int()
    valid = pos_mel > 0
    mel = torch.where(valid[..., None],
                      torch.randn(b, mel_len, hp.mel_dim, generator=gen),
                      torch.full((), -5.0))
    f0 = torch.where(valid, torch.rand(b, mel_len, generator=gen) * 740 + 60,
                     0.0)
    energy = torch.where(valid, torch.rand(b, mel_len, generator=gen) * 315,
                         0.0)
    batch = dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                 alignment=dur, f0=f0, energy=energy)
    return {k: v.to(device) for k, v in batch.items()}


def train_hparams(**overrides):
    """The transformer flagship (d 384, 6+6 layers, 4 heads of 96, bf16
    amp, dropout 0.1, Noam with warmup 4000, clip 1.0) with overrides."""
    from transformer_tts_tpu_torch.config import HParams
    return HParams(**dict(FLAGSHIP, **overrides))


def ar_hparams(**overrides):
    """The AR Transformer-TTS flagship of egs/transformer_tts_ljspeech.py
    (the defaults with model = "Transformer": d 384, 6+6 layers, 4 heads
    of 96, FFN kernels 5/1, r 2, bf16 amp, dropout 0.1, prenet dropout
    0.5, Noam with warmup 4000, clip 1.0, positive_weight 5) with
    overrides."""
    return train_hparams(**dict(overrides, model="Transformer"))


def ar_train_batch(gen, hp, b, text_len, mel_len, frames, device):
    """A collated AR batch: text as ``train_batch``'s; per row a zero go
    frame, then random mel, a count of frames (go frame included) drawn
    from ``frames``; pos_mel over that count rounded up to r, the mel pad
    -5.0 and stop_token 1.0 past the row's frames, as the collate pads."""
    r = hp.reduction_rate
    lens = torch.linspace(text_len, text_len // 2, b).round().long()
    text = torch.zeros(b, text_len, dtype=torch.int32)
    mel = torch.full((b, mel_len, hp.mel_dim), -5.0)
    stop = torch.ones(b, mel_len)
    totals = torch.randint(frames[0], frames[1] + 1, (b,), generator=gen)
    for i, (n, total) in enumerate(zip(lens.tolist(), totals.tolist())):
        text[i, :n] = torch.randint(1, hp.vocab_size, (n,), generator=gen,
                                    dtype=torch.int32)
        mel[i, 0] = 0.0
        mel[i, 1:total] = torch.randn(total - 1, hp.mel_dim, generator=gen)
        stop[i, :total] = 0.0
    rounded = -(-totals // r) * r
    pos = torch.arange(1, mel_len + 1)[None]
    pos_text = torch.where(text != 0, torch.arange(1, text_len + 1)[None],
                           0).int()
    pos_mel = torch.where(pos <= rounded[:, None], pos, 0).int()
    batch = dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                 stop_token=stop)
    return {k: v.to(device) for k, v in batch.items()}


def gst_hparams(**overrides):
    """The AR flagship with GST (egs/transformer_tts_ljspeech.py,
    ``gst = True``: a 6-conv reference encoder, a 128-unit GRU, 10 style
    tokens of 384 attended by 4 heads), with overrides."""
    return ar_hparams(**dict(overrides, gst=True))


def sq_hparams(**overrides):
    """The SQ-VAE FastSpeech 2 (``model = "SQFastSpeech2"``): the
    transformer flagship's widths and training defaults, a codebook of 128
    codes of 384, with overrides."""
    return train_hparams(**dict(overrides, model="SQFastSpeech2"))


def no_token_dropout(model):
    """The GST style token attention's dropout (0.1, not an hparam) at 0,
    for the card-vs-CPU step."""
    model.style_embedding.style_token_layer.attention.dropout.p = 0.0


def conformer_hparams(**overrides):
    """The conformer flagship of egs/fastspeech2_conformer_ljspeech.py:
    the transformer flagship's widths and training defaults with both
    stacks conformer, with overrides."""
    return train_hparams(**dict(overrides, **PATHS["conformer"][0]))


def trainer(kind: str) -> dict:
    """A flagship's training: its hparams, state, step and batch makers,
    the overrides that zero its dropouts, the name of its decoder's
    kernel-path attention, the ids of the kernels that carry it in fp32
    (forward at rate 0, forward with dropout, dq, dk/dv: the card-vs-CPU
    step's), in bf16 with no dropout where they differ (``bf16_kernels``,
    the Hopper design's forward and fused backward), and in the bf16
    train step (``step_kernels``: each launches once per decoder layer),
    and the (module, name) of the kernel path's
    forward and backward entries, whose calls the timed step captures."""
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    from transformer_tts_tpu_torch.train import trainer as tr
    fs2_no_dropout = dict(dropout=0.0, dropout_postnet=0.0,
                          dropout_variance_adaptor=0.0)
    calls = dict(fwd_call=(attention, "flash_attention"),
                 bwd_call=(fa, "flash_attention_bwd"))
    if kind in ("xvector", "spkconf"):
        return conditioned_trainer(kind)
    if kind in ("tacotron2", "discrete", "sqspk"):
        return other_trainer(kind)
    if kind == "fastspeech2":
        return dict(hparams=train_hparams, init=tr.init_fastspeech2_state,
                    make_step=tr.make_fastspeech2_train_step,
                    batch=train_batch, attn="attn", no_dropout=fs2_no_dropout,
                    kernels=("K1", "K1-d", "K2-dq", "K2-dkdv"),
                    bf16_kernels=("K1-90", "K2-90"),
                    step_kernels=("K1-d-90", "K2-90"), **calls)
    if kind == "conformer":
        return dict(hparams=conformer_hparams,
                    init=tr.init_fastspeech2_state,
                    make_step=tr.make_fastspeech2_train_step,
                    batch=train_batch, attn="attn", no_dropout=fs2_no_dropout,
                    kernels=("K4", "K4-d", "K5-dq", "K5-dkdv"),
                    bf16_kernels=("K4-90", "K5-90"),
                    step_kernels=("K4-d-90", "K5-90"),
                    control=("coverage", "norms"),
                    fwd_call=(attention, "flash_relpos_attention"),
                    bwd_call=(fr, "flash_relpos_attention_bwd"))
    if kind == "sq":
        return dict(hparams=sq_hparams, init=tr.init_sq_fastspeech2_state,
                    make_step=tr.make_sq_fastspeech2_train_step,
                    batch=train_batch, attn="attn", no_dropout=fs2_no_dropout,
                    kernels=("K1", "K1-d", "K2-dq", "K2-dkdv"),
                    bf16_kernels=("K1-90", "K2-90"),
                    step_kernels=("K1-d-90", "K2-90"), terms=True,
                    live=("variance_adaptor.codebook.",
                          "variance_adaptor.log_var_q_scalar",
                          "variance_adaptor.duration_predictor."), **calls)
    ar = dict(hparams=ar_hparams, init=tr.init_transformer_state,
              make_step=tr.make_transformer_train_step,
              batch=ar_train_batch, attn="attn_1",
              no_dropout=dict(dropout=0.0, dropout_prenet=0.0,
                              dropout_postnet=0.0),
              kernels=("K3-f", "K3-d", "K3-dq", "K3-dkdv"),
              bf16_kernels=("K3-f-90", "K3-90"),
              step_kernels=("K3-d-90", "K3-90"), **calls)
    if kind == "gst":
        ar.update(hparams=gst_hparams, prepare=no_token_dropout,
                  live=("style_embedding.",))
    return ar


def conditioned_trainer(kind: str) -> dict:
    """Phase 18's kinds: "xvector", the transformer flagship with
    XVECTOR_COND, and "spkconf", the conformer with SPKCONF_COND (its
    adaptor's positional dropout at 0 for the card-vs-CPU step), on
    batches with their conditioning; ``live`` the conditioning weights,
    each of which must get a card gradient."""
    if kind == "xvector":
        spec, cond = trainer("fastspeech2"), XVECTOR_COND
        live = ("spk_proj.", "hop_emb.", "decoder.ctc_linear.",
                "encoder.layers.0.spk_bias.", "decoder.layers.0.spk_bias.")
    else:
        spec, cond = trainer("conformer"), SPKCONF_COND
        live = ("encoder.acc_embed.", "encoder.layers.0.multi_emb.",
                "decoder.layers.0.multi_emb.", "variance_adaptor.pos.",
                "variance_adaptor.rnn_length.")
        spec["prepare"] = no_pos_dropout
        # only the bf16 norm check is re-derived here: the fp32 update
        # coverage keeps its floor of 50 %
        spec["control"] = ("norms",)

    def batch(gen, hp, *args):
        return conditioned(gen, hp, train_batch(gen, hp, *args))

    spec.update(hparams=lambda **o: train_hparams(**dict(o, **cond)),
                batch=batch, live=live)
    return spec


ADAM_EPS = 1e-9
# gradients, card fp32 against CPU fp32, each within this share of its own
# max|g|: sums run in other orders, and a ReLU whose input lies within
# rounding of 0 takes the other branch on one side, which moves its
# layer's weight gradient by up to ~1/sqrt(B*T) of max|g| (B*T = 1536
# here). The decoder attention weights, fed by K2 directly, hold tighter.
GRAD_TOL, ATTN_GRAD_TOL = 2e-2, 5e-3
# the conformer's re-derived checks, each against the same step through the
# plain masked attention (``control_steps``): under flax's draw the padded
# rows' LayerNorm gradient (1/sqrt(eps) on exact zeros, JAX's conformer
# has it too) sets the clip, leaving the decoder attention gradients near
# Adam's eps, and bf16 moves this model's attention gradient norms by
# 7-17 % from fp32 with no kernel in the path. So phase 5's fp32 update
# coverage must be at least this share of the control's (18(b)'s keeps its
# absolute floor), and the bf16 attention gradient norms of both within
# this multiple of the control's distance from the CPU's fp32 and each
# within KERNEL_VS_CONTROL of the control's own
COVERAGE_OF_CONTROL, NORM_OF_CONTROL = 0.5, 1.25
KERNEL_VS_CONTROL = 0.05


def zero_in_exact_arithmetic(name: str) -> bool:
    """Gradients that cancel to 0, leaving rounding noise: a key bias (it
    adds one constant to each softmax row) and the conv biases before a
    BatchNorm (its batch mean takes them out): the postnet's and, in the
    conformer, each conv module's depthwise conv and the 1x1 conv after
    it."""
    return name.endswith("k_linear.bias") or (
        name.startswith("postnet.") and name.endswith(".bias")
        and (".conv1." in name or ".conv_list." in name)) or (
        ".conv_module.depth_conv1." in name and name.endswith(".bias"))


def decoder_attention(hp, attn: str) -> tuple:
    """Names of the decoder kernel-path attention's weights, whose
    gradients come through K2 (FastSpeech 2), K3 (the AR model) or K5 (the
    conformer, whose relative attention adds linear_pos and the two
    position biases)."""
    if hp.decoder_type.lower() == "tacotron2":      # no kernel: GRAD_TOL
        return tuple(f"decoder.{m}.weight" for m in (
            "AttentionConv", "AttentionConvProj", "AttentionEncoderProj",
            "AttentionDecoderProj", "AttentionSelfProj"))
    members = ["q_linear.weight", "k_linear.weight", "v_linear.weight",
               "out.weight"]
    if hp.decoder_type.lower() == "conformer":
        members += ["linear_pos.weight", "pos_bias_u", "pos_bias_v"]
    return tuple(f"decoder.layers.{i}.{attn}.{m}"
                 for i in range(hp.n_layer_decoder) for m in members)


# a ReLU input within this share of its call's max|x| lies within rounding
# of 0, where card and CPU may take either branch: the one such tie read
# out of an AR step had |x| = 1.5e-7 against max|x| = 7.27 (2.1e-8)
RELU_TIE = 1e-7
# at most this many ReLU inputs of one train step may take the card's
# branch on the CPU
RELU_FLIPS = 8


@contextmanager
def relu_branches(record=None, follow=None):
    """Within the block, ``torch.relu`` (every ReLU of the models) either
    appends each call's branch, x > 0 on the CPU, to the list ``record``,
    or, given ``follow`` (the branches another run recorded, call by
    call), takes that run's branch where its own input lies within
    RELU_TIE of 0 and the two differ. At such a tie both branches are
    right; a different one moves the layer's weight gradient by up to
    ~1/sqrt(B*T) of its max|g| (one flipped encoder unit in B*T = 256
    text positions: 3.3 %), which is not a disagreement of the two
    devices' arithmetic. Yields [the count of branches taken from
    ``follow``, the largest |x| / max|x| among them]."""
    real = torch.relu
    calls = iter(follow or ())
    forced = [0, 0.0]

    def relu(x):
        if record is not None:
            record.append((x > 0).cpu())
            return real(x)
        other = next(calls).to(x.device)
        check(other.shape == x.shape, "the ReLU calls of the two runs differ")
        top = x.abs().amax()
        take = (x.abs() <= RELU_TIE * top) & (other != (x > 0))
        if bool(take.any()):
            forced[0] += int(take.sum())
            forced[1] = max(forced[1],
                            float(x.detach().abs()[take].max() / top))
        return torch.where(take, x * other, real(x))

    if record is None and follow is None:
        yield forced
        return
    torch.relu = relu
    try:
        yield forced
    finally:
        torch.relu = real


# a codebook row whose two nearest codes lie within this share of the
# nearer's distance is a tie: card and CPU fp32 move a distance of ~40 by
# ~1e-6 of it through six encoder layers
ARGMIN_TIE = 1e-5


@contextmanager
def argmin_ties(record=None, follow=None):
    """Within the block, ``torch.argmin`` (the SQ-VAE codebook's nearest
    code, models/sq_vae.py) either appends each call's (distances,
    indices) to the list ``record``, or, given ``follow`` (another run's
    records, call by call), takes that run's index at rows where its own
    argmin differs and the two codes' distances lie within ARGMIN_TIE of
    each other: at such a tie either code is right, as at a ReLU's
    (``relu_branches``). Yields [rows taken from ``follow``, the largest
    gap / distance among them, rows that differ beyond a tie]."""
    real = torch.argmin
    calls = iter(follow or ())
    forced = [0, 0.0, 0]

    def argmin(d, dim=-1, *a, **kw):
        idx = real(d, dim, *a, **kw)
        if record is not None:
            record.append((d.detach().float().cpu(), idx.cpu()))
            return idx
        _, other = next(calls)
        other = other.to(idx.device)
        check(other.shape == idx.shape, "the argmin calls of the runs differ")
        rows = (other != idx).nonzero()[:, 0]
        if rows.numel():
            dd = d.detach().float()
            near = dd[rows, idx[rows]]
            gap = (dd[rows, other[rows]] - near).abs() / near.abs().clamp(
                min=1e-30)
            tie = gap <= ARGMIN_TIE
            forced[0] += int(tie.sum())
            forced[2] += int((~tie).sum())
            if bool(tie.any()):
                forced[1] = max(forced[1], float(gap[tie].max()))
            idx = idx.clone()
            idx[rows[tie]] = other[rows[tie]]
        return idx

    if record is None and follow is None:
        yield forced
        return
    torch.argmin = argmin
    try:
        yield forced
    finally:
        torch.argmin = real


def ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def settled_share_of(g: torch.Tensor, g_ref: torch.Tensor) -> tuple:
    """(settled mask, its share): where two gradients within their max abs
    difference err of each other bound Adam's first updates within 1e-3
    lr of each other (see ``phase_card_vs_cpu``)."""
    err, _ = max_err(g, g_ref)
    least = (g_ref.abs() - err).clamp(min=0.0)
    settled = err * ADAM_EPS / (least + ADAM_EPS) ** 2 <= 1e-3
    return settled, settled.float().mean().item()


def attention_norms(model, cpu_params, attn) -> dict:
    """name -> (card gradient norm, CPU gradient norm) of each decoder
    attention weight."""
    params = dict(model.named_parameters())
    return {n: (params[n].grad.float().norm().item(),
                cpu_params[n].grad.norm().item()) for n in attn}


def norm_rel(norms: dict) -> float:
    return max(abs(x - y) / y for x, y in norms.values())


def control_steps(spec, fp32, weights, batch, prepare) -> dict:
    """amp -> the train state after the same step from the same weights on
    the card through the plain masked attention (``use_flash_attention``
    off), every kernel counter at 0 and still 0 after it: the same-run
    control of the conformer's re-derived checks (``spec["control"]``:
    "coverage" the fp32 step's, "norms" the bf16 step's)."""
    states = {}
    for amp, check_name in ((False, "coverage"), (True, "norms")):
        if check_name not in spec["control"]:
            continue
        hp = spec["hparams"](**dict(fp32, amp=amp,
                                    use_flash_attention=False))
        state = spec["init"](hp, device=DEVICE)
        state.model.load_state_dict(weights)
        prepare(state.model)
        set_counts({})
        state, _ = spec["make_step"](hp, device=DEVICE)(state, batch)
        torch.cuda.synchronize()
        check(not any(read_counts().values()),
              f"the plain masked control launched a kernel: "
              f"{read_counts()}")
        states[amp] = state
    return states


def phase_card_vs_cpu(gen, kind):
    """One train step on the card and on the CPU from the same weights:
    the flagship in fp32 with every dropout 0, where the decoder takes K1
    and K2 (FastSpeech 2), K4 and K5 (the conformer) or K3 and its
    backward (the AR model, 383 decoder groups) on the simple design; then
    the same step with bf16 amp on the card, which every flagship must
    take on the Hopper design alone (K1-90 and K2-90, K4-90 and K5-90,
    K3-f-90 and K3-90). Every decoder attention weight's card gradient
    must be non-zero.
    warmup_step 10 makes Adam's first update lr * g / (|g| + 1e-9) ~
    lr * sign(g) with lr = 1.6e-3, far above fp32's rounding of the
    weights, so the updates show every gradient's sign, however small the
    gradient. The CPU's step follows the card's fp32 step at ReLU inputs
    within rounding of 0 (``relu_branches``)."""
    t_start = time.perf_counter()
    spec = trainer(kind)
    b, text_len, mel_len, frames = spec.get("cpu_batch", CPU_STEP_BATCH)
    fp32 = dict(spec["no_dropout"], amp=False, warmup_step=10)
    hp32 = spec["hparams"](**fp32)
    batch = spec["batch"](gen, hp32, b, text_len, mel_len, frames, "cpu")
    ref = spec["init"](hp32, device="cpu")
    weights = {k: v.clone() for k, v in ref.model.state_dict().items()}
    prepare = spec.get("prepare", lambda model: None)
    prepare(ref.model)
    counts = read_counts()
    results, launched, branches, codes = {}, {}, [], []
    for amp in (False, True):
        hp = spec["hparams"](**dict(fp32, amp=amp))
        state = spec["init"](hp, device=DEVICE)
        state.model.load_state_dict(weights)
        prepare(state.model)
        before = read_counts()
        with relu_branches(record=None if amp else branches), \
                argmin_ties(record=None if amp else codes):
            state, logs = spec["make_step"](hp, device=DEVICE)(state, batch)
        torch.cuda.synchronize()
        launched[amp] = {k: n - before[k] for k, n in read_counts().items()}
        results[amp] = (state, logs)
    with relu_branches(follow=branches) as forced, \
            argmin_ties(follow=codes) as ties:
        ref, ref_logs = spec["make_step"](hp32, device="cpu")(ref, batch)
    check(ties[2] == 0, f"{kind}: {ties[2]} codebook rows took another code "
                        f"on the CPU than on the card, beyond a tie")
    lr = ref.optimizer.schedule(0)
    check(forced[0] <= RELU_FLIPS,
          f"{kind}: {forced[0]} ReLU inputs within rounding of 0 took "
          f"another branch on the CPU than on the card (at most "
          f"{RELU_FLIPS})")
    if not spec["kernels"]:       # a decoder with no kernel (Tacotron 2)
        check(not any(n for run in launched.values() for n in run.values()),
              f"{kind}: a kernel launched: {launched}")
    else:
        fwd, _, dq, dkdv = spec["kernels"]
        check(all(launched[False][k] > 0 for k in (fwd, dq, dkdv)),
              f"{kind}: the card's fp32 step did not take {fwd}, {dq} and "
              f"{dkdv}: {launched[False]}")
    if spec["bf16_kernels"]:      # bf16, no dropout: the Hopper design
        h_fwd, h_bwd = spec["bf16_kernels"]
        check(launched[True][h_fwd] > 0 and launched[True][h_bwd] > 0
              and not any(launched[True][k] for k in (fwd, dq, dkdv)),
              f"{kind}: the card's bf16 step did not take {h_fwd} and "
              f"{h_bwd} alone: {launched[True]}")
    control = (control_steps(spec, fp32, weights, batch, prepare)
               if spec.get("control") else {})
    set_counts(counts)

    state, logs = results[False]
    loss, ref_loss = float(logs["loss_total"]), float(ref_logs["loss_total"])
    # fp32 on both sides (TF32 off): sums in other orders through 12 layers
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
          f"card fp32 loss {loss} vs CPU {ref_loss}")
    if spec.get("terms"):
        terms = {k: (float(logs[k]), float(v)) for k, v in ref_logs.items()}
        print(f"{kind} train step card fp32 vs CPU fp32, each loss term "
              f"(tol 1e-4 of max(1, |CPU|)): " + ", ".join(
                  f"{k} {a:.6f} vs {b:.6f}" for k, (a, b) in terms.items())
              + f"; codebook rows at a tie (within {ARGMIN_TIE:g} of the "
              f"distance) where the CPU took the card's code: {ties[0]}, "
              f"the largest gap {ties[1]:.3g}")
        check(all(abs(a - b) <= 1e-4 * max(1.0, abs(b))
                  for a, b in terms.values()),
              f"{kind}: card loss terms disagree with the CPU's: {terms}")
    cpu_params = dict(ref.model.named_parameters())
    # the .grad the optimizer left: clipped in place, on both sides alike
    top = max(p.grad.abs().max().item() for p in cpu_params.values())
    grad_rel, update_rel, settled_share, noise_peak = {}, {}, {}, 0.0
    for name, p in state.model.named_parameters():
        g, g_ref = p.grad.cpu(), cpu_params[name].grad
        old = weights[name]
        step = p.detach().cpu() - old
        ref_step = cpu_params[name].detach() - old
        rounding = 2 * ulp(old.abs() + lr)
        check(bool((step.abs() <= lr * (1 + 1e-4) + rounding).all()),
              f"{name}: an update larger than lr")
        err, peak = max_err(g, g_ref)
        if zero_in_exact_arithmetic(name):
            # noise on both sides, which Adam's first step turns into any
            # update in [-lr, lr]
            noise_peak = max(noise_peak, peak, g.abs().max().item())
            continue
        grad_rel[name] = err / peak if peak > 0 else float(err > 0)
        # Adam's first update is lr * f(g), f(x) = x / (|x| + eps), whose
        # slope eps / (|x| + eps)^2 is largest where |x| is least; between
        # two gradients within err of each other |x| >= m = max(|g| - err,
        # 0), so their updates lie within lr * err * eps / (m + eps)^2.
        # Where that bound is <= 1e-3 lr (a gradient far above err, or err
        # far below eps), the updates must agree to 1e-3 lr.
        settled, settled_share[name] = settled_share_of(g, g_ref)
        update_rel[name] = ((step - ref_step).abs() - rounding)[
            settled].max().item() / lr if settled.any() else 0.0
    stats_rel = 0.0
    cpu_buffers = dict(ref.model.named_buffers())
    for name, v in state.model.named_buffers():
        if "running" in name:
            err, peak = max_err(v.cpu(), cpu_buffers[name])
            stats_rel = max(stats_rel, err / max(peak, 1e-30))
    attn = decoder_attention(hp, spec["attn"])
    worst = sorted(grad_rel, key=grad_rel.get)[-3:]
    attn_worst = max(attn, key=grad_rel.get)
    attn_peaks = [cpu_params[n].grad.abs().max().item() for n in attn]
    card_params = dict(state.model.named_parameters())
    dead = [n for n in attn if not bool((card_params[n].grad != 0).any())]
    check(not dead, f"{kind}: decoder attention weights with no card "
                    f"gradient: {dead}")
    live = [n for n in card_params if n.startswith(spec.get("live", ()))]
    dead = [n for n in live if not bool((card_params[n].grad != 0).any())]
    check(not dead, f"{kind}: weights with no card gradient: {dead}")
    if live:
        print(f"{kind}: {len(live)} weights of {spec['live']}, each with a "
              f"non-zero card gradient, within "
              f"{max(grad_rel.get(n, 0.0) for n in live):.3g} of their own "
              f"max|g| (tol {GRAD_TOL})")
    attn_share = min(settled_share[n] for n in attn)
    print(f"{kind} train step B={b} L={text_len} T={mel_len} card fp32 vs "
          f"CPU fp32:"
          f" loss {loss:.6f} vs {ref_loss:.6f}; gradients, each against its "
          f"own max|g| (tol {GRAD_TOL}): worst "
          + ", ".join(f"{n} {grad_rel[n]:.3g}" for n in worst)
          + f"; of the decoder attention weights (tol "
          f"{spec.get('attn_tol', ATTN_GRAD_TOL)}) "
          f"{attn_worst} {grad_rel[attn_worst]:.3g}, their max|g| "
          f"{min(attn_peaks):.3g}"
          f"..{max(attn_peaks):.3g} (largest gradient {top:.3g}); "
          f"key and pre-BatchNorm conv biases, zero but for rounding, "
          f"at most {noise_peak:.3g} (tol {1e-5 * top:.3g}); "
          f"updates at lr {lr:.4g}: worst |d update| / lr "
          f"{max(update_rel.values()):.3g} (tol 1e-3) where the gradients "
          f"bound it below 1e-3, at least {attn_share:.1%} of each decoder "
          f"attention "
          f"weight; BatchNorm statistics {stats_rel:.3g} of their own "
          f"max|ref| (tol 1e-3); ReLU inputs within {RELU_TIE:g} of their "
          f"call's max|x| where the CPU took the card's branch: {forced[0]} "
          f"(at most {RELU_FLIPS}) of {sum(x.numel() for x in branches)}, "
          f"the largest at {forced[1]:.3g} of max|x|; card launches "
          f"{json.dumps(launched)}")
    check(max(grad_rel.values()) <= GRAD_TOL
          and grad_rel[attn_worst] <= spec.get("attn_tol", ATTN_GRAD_TOL)
          and noise_peak <= 1e-5 * top,
          f"{kind}: card gradients disagree with the CPU's: worst {worst}")
    stats = {"shares": {n: settled_share[n] for n in attn}}
    share_floor = 0.5
    if False in control:
        c_params = dict(control[False].model.named_parameters())
        stats["control_shares"] = {
            n: settled_share_of(c_params[n].grad.cpu(),
                                cpu_params[n].grad)[1] for n in attn}
        control_share = min(stats["control_shares"].values())
        share_floor = COVERAGE_OF_CONTROL * control_share
        print(f"{kind} fp32 update coverage, re-derived: the kernel path's "
              f"{attn_share:.1%} of each decoder attention weight against "
              f"the plain masked path's {control_share:.1%} in the same "
              f"step from the same weights (kernel counters 0); needed "
              f"{COVERAGE_OF_CONTROL:g} of the control's, {share_floor:.1%}")
    check(max(update_rel.values()) <= 1e-3 and attn_share >= share_floor,
          f"{kind}: card updates disagree with the CPU's")
    check(stats_rel <= 1e-3, f"{kind}: card BatchNorm statistics disagree")

    state, logs = results[True]
    loss, norm = float(logs["loss_total"]), float(logs["grad_norm"])
    ref_norm = float(ref_logs["grad_norm"])
    norms = stats["norms"] = attention_norms(state.model, cpu_params, attn)
    rel, norm_tol = norm_rel(norms), 0.05
    print(f"{kind} train step card bf16 amp vs CPU fp32: loss {loss:.6f} vs "
          f"{ref_loss:.6f} (tol 2e-2 relative), grad_norm {norm:.6f} vs "
          f"{ref_norm:.6f} (tol 5 %), the decoder attention weights' "
          f"gradient norms within {rel:.3g}")
    vs_control = 0.0
    if True in control:
        c_norms = stats["control_norms"] = attention_norms(
            control[True].model, cpu_params, attn)
        norm_tol = max(0.05, NORM_OF_CONTROL * norm_rel(c_norms))
        vs_control = max(abs(norms[n][0] - c_norms[n][0]) / c_norms[n][0]
                         for n in attn)
        print(f"{kind} bf16 attention gradient norms, re-derived: the "
              f"kernel path within {rel:.3g} of the CPU's fp32, the plain "
              f"masked path in the same step from the same weights "
              f"(kernel counters 0) within {norm_rel(c_norms):.3g}, needed "
              f"max(0.05, {NORM_OF_CONTROL:g} x the control's) = "
              f"{norm_tol:.3g}; the kernel path within {vs_control:.3g} of "
              f"the control's, each weight's (tol {KERNEL_VS_CONTROL:g})")
    # bf16 keeps ~3 significant digits through 12 layers and the postnet
    check(abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)
          and abs(norm - ref_norm) <= 0.05 * ref_norm
          and rel <= norm_tol and vs_control <= KERNEL_VS_CONTROL,
          f"{kind}: card bf16 amp step disagrees with the CPU's")
    print(f"{kind} card-vs-CPU steps: {time.perf_counter() - t_start:.1f} s")
    return stats


def train_run(kind, batch) -> dict:
    """A bf16 train state of ``kind`` at full width, dropout 0.1, after 3
    warm-up steps on ``batch``, the last one's kernel path calls captured
    (the first decoder layer's forward, and its backward, which runs
    last): {kind, hp, spec, state, step, batch, held: the card bytes it
    holds, fwd_inputs, bwd_inputs}."""
    spec = trainer(kind)
    gc.collect()        # the models earlier checks left in reference cycles
    resident = torch.cuda.memory_allocated()    # what earlier phases hold
    hp = spec["hparams"]()
    state = spec["init"](hp, device=DEVICE)
    step = spec["make_step"](hp, device=DEVICE)
    fwd_calls, bwd_calls = [], []
    kernel_path = bool(spec["step_kernels"])     # Tacotron 2's has none
    for i in range(3):
        if i == 2 and kernel_path:      # the last warm-up step's inputs
            with capture_calls(*spec["fwd_call"], fwd_calls), \
                    capture_calls(*spec["bwd_call"], bwd_calls):
                state, _ = step(state, batch)
        else:
            state, _ = step(state, batch)
    torch.cuda.synchronize()
    n_calls = hp.n_layer_decoder if kernel_path else 0
    check(len(fwd_calls) == n_calls and len(bwd_calls) == n_calls,
          f"{kind}: kernel path calls per step")
    run = dict(kind=kind, hp=hp, spec=spec, state=state, step=step,
               batch=batch, fwd_inputs=fwd_calls[0] if kernel_path else None,
               bwd_inputs=bwd_calls[-1] if kernel_path else None)
    del fwd_calls, bwd_calls            # the other layers' inputs
    run["held"] = torch.cuda.memory_allocated() - resident
    return run


def time_train_steps(run) -> dict:
    """10 timed steps of ``run`` (``train_run``'s, whose state they
    advance), with the peak memory reset and every launch count set to 0
    just before: each step must launch the kind's kernels once per
    decoder layer and no other, the losses must be finite. Returns ms
    (the median by CUDA events), step_ms (each), frames_s (valid mel
    frames), own_gb (the peak over what the card holds besides the run:
    weights, optimizer, activations), other_gb (that), launches (the
    run's), per_step, want, losses and terms (the last step's logs)."""
    kind, hp, step, batch = run["kind"], run["hp"], run["step"], run["batch"]
    gc.collect()
    other = torch.cuda.memory_allocated() - run["held"]
    torch.cuda.reset_peak_memory_stats()
    set_counts({})                          # the main path starts here
    state, per_step, times, losses = run["state"], [], [], []
    for _ in range(10):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, batch)
        end.record()
        losses.append(logs["loss_total"])
        per_step.append({k: c - before[k] for k, c in read_counts().items()})
        times.append((start, end))
    torch.cuda.synchronize()
    launches = read_counts()                # it ends here
    run["state"] = state
    own_gb = (torch.cuda.max_memory_allocated() - other) / 1e9
    step_ms = [s.elapsed_time(e) for s, e in times]
    ms = statistics.median(step_ms)
    losses = torch.stack(losses).float().cpu()
    want = {k: 0 for k in counters()}
    want.update({k: hp.n_layer_decoder for k in run["spec"]["step_kernels"]})
    check(all(c == want for c in per_step),
          f"{kind} train step launches {per_step} differ from {want}")
    check(bool(torch.isfinite(losses).all()), f"{kind}: non-finite loss")
    return dict(ms=ms, step_ms=step_ms,
                frames_s=int((batch["pos_mel"] > 0).sum()) / ms * 1e3,
                own_gb=own_gb, other_gb=other / 1e9, launches=launches,
                per_step=per_step, want=want, losses=losses,
                terms={k: round(float(v), 4) for k, v in logs.items()})


def phase_train_step(batch, kind):
    """The main path of a flagship's training at full width, bf16 amp,
    dropout 0.1, on a fixed batch (TRAIN_BATCH): ``train_run``'s 3
    warm-up steps, then ``time_train_steps``' 10, kept for
    ``profile_train_step``; then 20 steps from a new state with
    warmup_step 100 whose loss must fall. The peak memory is also given as
    the step's own, over what earlier phases hold. Returns the timed
    run's launch counts and the kernel path's forward and backward inputs
    of the first decoder layer in the last warm-up step."""
    t_start = time.perf_counter()
    b, text_len, mel_len, _ = TRAIN_BATCH
    run = train_run(kind, batch)
    r = time_train_steps(run)
    ms, frames_valid = r["ms"], int((batch["pos_mel"] > 0).sum())
    print(f"{kind} train step B={b} L={text_len} T={mel_len} bf16 amp "
          f"dropout 0.1: {ms:.3f} ms/step (median of 10), {frames_valid} "
          f"valid mel frames = {r['frames_s']:.0f} frames/s "
          f"({b * mel_len / ms * 1e3:.0f} bucket frames/s), peak memory "
          f"{r['own_gb'] + r['other_gb']:.2f} GB = the step's own "
          f"{r['own_gb']:.3f} GB (weights, optimizer, activations) over "
          f"{r['other_gb']:.3f} GB that earlier phases hold; losses "
          f"{[round(x, 4) for x in r['losses'].tolist()]}")
    print(f"{kind} train main path: launches per step "
          f"{json.dumps(r['per_step'][0])} (expect {json.dumps(r['want'])}),"
          f" total {json.dumps(r['launches'])}")
    PROFILES.append(partial(profile_train_step, run, ms))
    fwd_inputs, bwd_inputs = run["fwd_inputs"], run["bwd_inputs"]
    spec = run["spec"]
    del run
    torch.cuda.empty_cache()

    hp = spec["hparams"](warmup_step=100)
    state = spec["init"](hp, device=DEVICE)
    step = spec["make_step"](hp, device=DEVICE)
    curve = []
    for _ in range(20):
        state, logs = step(state, batch)
        curve.append(logs["loss_total"])
    curve = torch.stack(curve).float().cpu().tolist()
    print(f"{kind}: 20 steps on one batch, warmup_step 100: loss "
          f"{curve[0]:.4f} -> {curve[-1]:.4f} "
          f"({[round(x, 3) for x in curve]})")
    check(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0],
          f"{kind}: the loss did not fall over 20 steps")
    del state, step
    torch.cuda.empty_cache()
    print(f"{kind} train step phase: {time.perf_counter() - t_start:.1f} s")
    return r["launches"], fwd_inputs, bwd_inputs


def profile_train_step(run, ms_per_step):
    """``print_profile`` of one train step of ``run`` (``train_run``'s),
    going on from the state its timed steps left (warm)."""
    print_profile(f"the {run['kind']} train step",
                  partial(run["step"], run["state"], run["batch"]), 1,
                  ms_per_step)


def write_train_corpus(gen, hp, root):
    """A synthetic corpus at flagship width: mels with alignment, f0 and
    energy siblings, and a script file."""
    n_utts, (lo, hi), _ = CLI_CORPUS
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n_utts):
        frames = int(torch.randint(lo, hi + 1, (), generator=gen))
        n_text = max(1, frames // 6)
        dur = torch.full((n_text,), frames // n_text, dtype=torch.int32)
        dur[: frames - int(dur.sum())] += 1
        base = os.path.join(root, f"utt{i}.npy")
        np.save(base, torch.randn(frames, hp.mel_dim,
                                  generator=gen).numpy())
        np.save(base.replace(".npy", "_alignment.npy"), dur.numpy())
        np.save(base.replace(".npy", "_f0.npy"),
                (torch.rand(frames, generator=gen) * 740 + 60).numpy())
        np.save(base.replace(".npy", "_energy.npy"),
                (torch.rand(frames, generator=gen) * 315).numpy())
        ids = torch.randint(1, hp.vocab_size, (n_text,), generator=gen)
        lines.append(f"{base}|{' '.join(map(str, ids.tolist()))}")
    script = os.path.join(root, "train.txt")
    with open(script, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return script


TRAIN_CLIS = {}                 # kind -> what phase_train_clis runs


def phase_train_cli(gen, kind, name=None, train_flags=()):
    """Write ``kind``'s synthetic corpus, hparams and test script for
    ``phase_train_clis``, which runs every kind's CLIs at once (under
    ``name``, default the kind, its training CLI with ``train_flags``)."""
    hp = trainer(kind)["hparams"]()
    name = name or kind
    work = os.path.join(WORK, f"train_{name.replace(' --', '_')}")
    script = write_train_corpus(gen, hp, os.path.join(work, "corpus"))
    save_dir = os.path.join(work, "checkpoints")
    hp_file = os.path.join(work, "hparams.py")
    with open(hp_file, "w") as fh:
        for key, value in dict(FLAGSHIP, model=hp.model,
                               encoder_type=hp.encoder_type,
                               decoder_type=hp.decoder_type,
                               **({"gst": True} if hp.gst else {}),
                               train_script=script, save_dir=save_dir,
                               batch_size=CLI_CORPUS[2], max_epoch=1,
                               save_per_epoch=1,
                               num_workers=CLI_WORKERS).items():
            fh.write(f"{key} = {value!r}\n")
    test_script = os.path.join(work, "test.txt")
    with open(script) as src, open(test_script, "w") as dst:
        dst.write("".join(src.readlines()[:3]))
    flags = []
    if hp.gst:                  # the style of a reference mel
        flags = ["--ref_mel", os.path.join(work, "ref.npy")]
        np.save(flags[1], torch.randn(GST_REF_FRAMES[1], hp.mel_dim,
                                      generator=gen).numpy())
    TRAIN_CLIS[name] = dict(hp=hp, hp_file=hp_file, test_script=test_script,
                            load_dir=os.path.join(save_dir, "epoch_1"),
                            out_dir=os.path.join(work, "generated"),
                            flags=flags, train_flags=list(train_flags))


def phase_train_clis(extra: dict, second: dict) -> dict:
    """cli/train.py for 3 steps on each prepared kind's corpus, and the
    ``extra`` runs ({name: argv}), all at once; then cli/synthesize.py on
    each kind's checkpoint and the ``second`` runs, all at once: each must
    exit 0, each training log 3 steps and save its checkpoint, each
    synthesis write 3 finite mels. Returns the extra and second runs'
    output."""
    outs = run_clis(dict({
        f"{kind} train CLI": ["transformer_tts_tpu_torch.cli.train",
                              "--hp_file", c["hp_file"], "--max_steps", "3",
                              "--device", DEVICE, *c["train_flags"]]
        for kind, c in TRAIN_CLIS.items()}, **extra))
    for kind, c in TRAIN_CLIS.items():
        steps = [ln for ln in outs[f"{kind} train CLI"].splitlines()
                 if ln.startswith("epoch 1 step")]
        print("\n".join(steps))
        check(len(steps) == 3, f"{kind} train CLI did not log 3 steps")
        check(os.path.exists(os.path.join(c["load_dir"], "model.pt"))
              and os.path.exists(os.path.join(c["load_dir"], "hparams.py")),
              f"{kind} train CLI saved no checkpoint")
    outs.update(run_clis(dict({
        f"{kind} synthesis CLI on the trained checkpoint": [
            "transformer_tts_tpu_torch.cli.synthesize", "--load_name",
            c["load_dir"], "--test_script", c["test_script"], "--save",
            c["out_dir"], "--max_frames", "2048", "--device", DEVICE,
            *c["flags"]]
        for kind, c in TRAIN_CLIS.items()}, **second)))
    for kind, c in TRAIN_CLIS.items():
        frames = []
        for i in range(3):
            mel = np.load(os.path.join(c["out_dir"], f"{i}.npy"))
            frames.append(mel.shape[0])
            check(mel.ndim == 2 and mel.shape[1] == c["hp"].mel_dim
                  and mel.shape[0] > 0 and bool(np.isfinite(mel).all()),
                  f"{kind} synthesis from the trained checkpoint: mel {i} "
                  f"{mel.shape}")
        print(f"{kind} train CLI: 3 steps, checkpoint "
              f"{os.path.relpath(c['load_dir'], ROOT)}; synthesis CLI "
              f"{' '.join(c['flags'][:1])} read it and wrote 3 mels of "
              f"{frames} frames")
    TRAIN_CLIS.clear()
    return {name: outs[name] for name in (*extra, *second)}


# ---- phase 6: the AR Transformer-TTS ----------------------------------------

AR_TF = (2, 128, 300)           # B, text bucket, decoder groups (>= 256)
AR_DECODE_STEPS = 300
AR_SYNTH_BATCHES = (1, 8)
AR_STOP_BIAS = -30.0            # no row stops: every call decodes 500 groups


def ar_model(device, amp: bool, seed: int = 0):
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    hp = ar_hparams(amp=amp)
    return hp, build_transformer_tts(hp, device=device, seed=seed).eval()


def group_positions(lengths, t: int):
    pos = torch.arange(1, t + 1)[None]
    return torch.where(pos <= torch.as_tensor(lengths)[:, None], pos, 0)


def phase_ar_teacher_forced(gen, gst: bool = False):
    """The AR flagship's teacher-forced forward in eval mode over
    AR_TF's 300 decoder groups, whose masked self-attention takes K3 at
    rate 0: card fp32 against the CPU's fp32 at 1e-3 of max(1, max|ref|)
    on mel_post and the stop logits, card bf16 amp at 5e-2 of it; each
    forward a path of its own, counted from 0 (6 launches of the simple
    K3-f in fp32, of the Hopper design's K3-f-90 in bf16, nothing else).
    With ``gst``, the GST model (``gst_model``) styled by a reference mel
    of GST_REF_FRAMES[0] frames. Returns the bf16 forward's launches and
    its first decoder layer's kernel input, the input K3-f-90 and K3-f
    are timed at."""
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops.masks import create_masks
    b, text_len, t = AR_TF
    build = gst_model if gst else ar_model
    hp, cpu_model = build("cpu", amp=False)
    text, pos_text = text_batch(gen, b, text_len, 100, hp.vocab_size)
    trg = torch.randn(b, t, hp.mel_dim, generator=gen)
    pos_mel = group_positions([t, t - 60], t)
    masks = create_masks(pos_text, pos_mel, model="transformer")
    inputs = (text.long(), trg, *masks)
    if gst:
        inputs += (torch.randn(1, GST_REF_FRAMES[0], hp.mel_dim,
                               generator=gen),)
    with torch.no_grad():
        ref = cpu_model(*inputs)
    del cpu_model
    _, model = build(DEVICE, amp=False)
    cuda_inputs = [x.to(DEVICE) for x in inputs]
    captured = []
    for amp in (False, True):
        model.amp = amp
        set_counts({})                      # this path starts here
        with torch.no_grad(), capture_calls(attention, "flash_attention",
                                            captured if amp else []):
            out = model(*cuda_inputs)
        torch.cuda.synchronize()
        launched = read_counts()            # and ends here
        want = {k: 0 for k in counters()}
        want["K3-f-90" if amp else "K3-f"] = hp.n_layer_decoder
        check(launched == want, f"AR eval forward launches {launched}, "
                                f"expected {want}")
        errs = {}
        for name in ("mel_post", "stop_token"):
            want_t = getattr(ref, name)
            errs[name] = max_err(getattr(out, name).cpu(), want_t)
        peak = max(p for _, p in errs.values())
        tol = (5e-2 if amp else 1e-3) * max(1.0, peak)
        label = "bf16 amp" if amp else "fp32"
        print(f"{'GST ' if gst else ''}AR teacher-forced forward B={b} "
              f"L={text_len} T_dec={t}: "
              f"card {label} vs CPU fp32: max|d mel_post| = "
              f"{errs['mel_post'][0]:.3g}, max|d stop| = "
              f"{errs['stop_token'][0]:.3g} (tol {tol:.3g}, max|ref| "
              f"{peak:.3g}); launches {json.dumps(launched)}")
        check(all(e <= tol for e, _ in errs.values()),
              f"AR: card {label} forward disagrees with the CPU")
    set_counts({})
    return launched, captured[0]


def phase_ar_decode_vs_forward(gen):
    """The KV-cached decode loop of synthesize_transformer_tts (fp32, no
    stop) for AR_DECODE_STEPS steps, counted from 0: no kernel launches;
    then the teacher-forced forward of the frames the loop fed itself,
    on the card (its self-attention on K3-f): each step's group must
    equal the forward's row within 1e-3 of max(1, max|ref|)."""
    from transformer_tts_tpu_torch.infer.synthesize import _ar_body, _ar_init
    from transformer_tts_tpu_torch.ops.masks import create_masks, pad_mask
    b, text_len, _ = AR_TF
    steps = AR_DECODE_STEPS
    hp, model = ar_model(DEVICE, amp=False)
    text, pos_text = (x.to(DEVICE) for x in text_batch(
        gen, b, text_len, 100, hp.vocab_size))
    text = text.long()
    src_mask = pad_mask(pos_text)
    set_counts({})                          # the decode starts here
    with torch.inference_mode():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        carry = _ar_init(model, b, steps, DEVICE)
        body = _ar_body(model, e_outputs, src_mask, cross, 2.0)
        fed = []
        for _ in range(steps):
            fed.append(carry["prev"].clone())   # the step writes in place
            body(carry)
    torch.cuda.synchronize()
    launched = read_counts()                # and ends here
    check(not any(launched.values()),
          f"the AR decode launched a kernel: {launched}")
    trg = torch.cat(fed, 1)
    pos_mel = group_positions([steps] * b, steps).to(DEVICE)
    with torch.no_grad():
        out = model(text, trg, *create_masks(pos_text, pos_mel,
                                             model="transformer"))
    set_counts({})
    err, peak = max_err(carry["groups"], out.mel_pre)
    tol = 1e-3 * max(1.0, peak)
    print(f"AR KV-cached decode, {steps} steps B={b} fp32: launches "
          f"{json.dumps(launched)}; every group against the teacher-forced "
          f"forward of the fed-back frames: max|d| = {err:.3g} (tol "
          f"{tol:.3g}, max|ref| {peak:.3g})")
    check(err <= tol, "the AR decode disagrees with the teacher-forced "
                      "forward")


@contextmanager
def stop_logits(model, store: list):
    """While the block runs, append to ``store`` (once it ends) the
    (steps, B, r) stop logits, without the stop head's bias, of the eager
    decode steps it runs: the head's input times its weight, both in the
    dtype the head computes in, in float64, with the weight the head has
    when the block ends. The block gets the list of the head's inputs, (B,
    d) a step. A row's stop changes nothing the loop feeds back, so the
    trajectory holds for any stop head. (The hooks fire in the eager loop
    only; a graph replays no Python.)"""
    seen = []
    hook = model.stop_token.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0][:, 0]))
    try:
        yield seen
    finally:
        hook.remove()
    dtype = model.cache_dtype           # what the head computes in
    x = torch.stack(seen).to(dtype).double()             # (steps, B, d)
    w = model.stop_token.weight.detach().to(dtype).double()
    store.append(torch.einsum("sbd,rd->sbr", x, w).cpu().numpy())


# the relative rounding of a bf16 logit, doubled: a stop-head output within
# this of 0 may round to either side
STOP_ROUNDING = 2.0 ** -7


def staggered_stop_weight(x: torch.Tensor, steps: int) -> torch.Tensor:
    """A stop-head weight (d,) under which the rows of a decode whose head
    inputs were ``x`` (steps, B, d) cross logit 0 at different steps,
    spread over the middle half of ``steps``: the ridge fit (1e-3 of the
    mean eigenvalue added) of logit (s - stop_b) / 8 at step s of row b.
    For a random draw whose stop logit peaks in the first steps of every
    row, where no bias alone staggers the stops."""
    n, b, d = x.shape
    stops = torch.linspace(steps // 4, 3 * steps // 4, b, dtype=torch.float64)
    target = (torch.arange(1, n + 1, dtype=torch.float64)[:, None]
              - stops[None, :]) / 8
    xs = x.reshape(n * b, d).double().cpu()
    gram = xs.T @ xs
    gram += 1e-3 * torch.trace(gram) / d * torch.eye(d, dtype=torch.float64)
    return torch.linalg.solve(gram, xs.T @ target.reshape(-1))


def stopping_bias(logits: np.ndarray, max_steps: int) -> float:
    """A stop-head bias at which every row stops before ``max_steps``, at
    as many different steps as the candidates offer, preferring none in
    the first block: a row stops at its first step whose mean stop
    probability, sigmoid(logit + bias) over the r frames, is above 0.5.
    The candidates lie midway between the levels at which a step's mean
    logit crosses 0, and a candidate counts only where no step up to a
    row's stop lies within ``STOP_ROUNDING`` of each logit's size from
    the other side of 0.5 (the head rounds logit + bias to its dtype), so
    rounding does not move a stop."""
    levels = np.unique(-logits.mean(-1))
    mids = (levels[1:] + levels[:-1]) / 2
    mids = mids[np.linspace(0, len(mids) - 1, min(len(mids), 1000))
                .round().astype(int)]
    best, best_key = None, None

    def stops(z):
        over = (1.0 / (1.0 + np.exp(-z))).mean(-1) > 0.5    # (steps, B)
        return over.any(0).all(), over.argmax(0) + 1

    for beta in mids:
        z = logits + beta
        slack = STOP_ROUNDING * np.maximum(np.abs(z), 1.0)
        (low_all, low), (high_all, high) = stops(z - slack), stops(z + slack)
        if not (low_all and high_all) or not np.array_equal(low, high):
            continue
        first = low
        key = (len(set(first.tolist())), first.min() > 8)
        if best_key is None or key > best_key:
            best, best_key = float(beta), key
    check(best is not None, "no stop bias makes every row stop")
    return best


def weight_casts(model, run) -> int:
    """Casts (``aten.to``, ``aten._to_copy``) of the model's parameters to
    another dtype while ``run()`` runs, seen by a TorchDispatchMode:
    autocast's casts of the weights."""
    from torch.utils._python_dispatch import TorchDispatchMode
    params = {p.data_ptr(): p.dtype for p in model.parameters()}
    casts = (torch.ops.aten.to, torch.ops.aten._to_copy)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket in casts
                    and args[0].data_ptr() in params
                    and out.dtype != params[args[0].data_ptr()]):
                self.n += 1
            return out

    with Count() as count:
        run()
    return count.n


def phase_ar_decode_weight_casts(model, text, pos):
    """One eager decode step on the card: the weight casts autocast makes
    with the fp32 parameters, and with the graph's bf16 copies
    (``DecodeWeights``) swapped in, as the graph captures the step: none."""
    from transformer_tts_tpu_torch.infer import synthesize as synth
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    src_mask = pad_mask(pos)
    with torch.inference_mode():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        weights = synth.DecodeWeights(model)

        def step():
            synth.ar_decode(model, e_outputs, src_mask, cross, 1, 0.5)
        plain = weight_casts(model, step)
        with weights.swapped_in():
            swapped = weight_casts(model, step)
    print(f"AR decode step B={text.shape[0]}: {plain} weight casts with the "
          f"fp32 parameters, {swapped} with the {len(weights.slots)} bf16 "
          f"copies the graph reads")
    check(plain > 0 and swapped == 0,
          f"AR decode step: {swapped} weight casts with the bf16 copies in")


def phase_ar_synthesis(gen):
    """synthesize_transformer_tts at the flagship's width, bf16 amp,
    max_steps 500, B=1 and B=8: the main path replays the decode's CUDA
    graph, its launches counted from 0 (none). The stop head's bias at
    AR_STOP_BIAS makes every row decode all 500 groups (the longest call);
    a second bias, chosen from both eager runs' stop logits, makes every
    row stop early, B=8's rows at different steps. At both biases and both batch sizes the
    graph's mel and lengths must equal the eager loop's bit for bit. Times
    at AR_STOP_BIAS, the graph's the median of 3 calls, the eager loop's
    of one (~10 ms a step): ms per call and per decode step, RTF; then
    a graphed call of PROFILE_AR_STEPS at each batch size timed, for its
    profile (run last)."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        MAX_AR_STEPS, synthesize_transformer_tts)
    hp, model = ar_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    batches = []
    for batch in AR_SYNTH_BATCHES:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        batches.append((text.long().to(DEVICE), pos.to(DEVICE)))
    frames = MAX_AR_STEPS * hp.reduction_rate
    set_counts({})                          # the path starts here
    for text, pos in batches:
        t0 = time.perf_counter()
        mel, lengths = synthesize_transformer_tts(model, text, pos)
        torch.cuda.synchronize()
        print(f"AR synthesis B={text.shape[0]}: first graphed call (warm-up "
              f"and capture) {(time.perf_counter() - t0) * 1e3:.1f} ms")
        check(mel.shape == (text.shape[0], frames, hp.mel_dim)
              and bool(torch.isfinite(mel).all())
              and bool((lengths == frames).all()),
              f"AR synthesis: mel {tuple(mel.shape)}, lengths "
              f"{lengths.tolist()}")
    launched = read_counts()                # and ends here
    check(not any(launched.values()),
          f"AR synthesis launched a kernel: {launched}")

    results, logits = {}, []
    for text, pos in batches:
        b = text.shape[0]
        results[b, "graph"] = wall_ms(
            lambda: synthesize_transformer_tts(model, text, pos), 3)
        with stop_logits(model, logits):
            results[b, "eager"] = wall_ms(
                lambda: synthesize_transformer_tts(model, text, pos,
                                                   eager=True), 1)
        (g_mel, g_len), (e_mel, e_len) = (results[b, n][1]
                                          for n in ("graph", "eager"))
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len),
              f"AR B={b}: the graph's mel or lengths differ from the eager "
              f"loop's")
    stop_bias = stopping_bias(np.concatenate(logits, axis=1), MAX_AR_STEPS)
    with torch.no_grad():
        model.stop_token.bias.fill_(stop_bias)
    for text, pos in batches:
        g_mel, g_len = synthesize_transformer_tts(model, text, pos)
        e_mel, e_len = synthesize_transformer_tts(model, text, pos,
                                                  eager=True)
        print(f"AR B={text.shape[0]} stop bias {stop_bias:.4f}: lengths "
              f"graph {g_len.tolist()}, eager {e_len.tolist()}")
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len),
              f"AR B={text.shape[0]} with stops: the graph differs from "
              f"the eager loop")
        check(int(g_len.max()) < frames
              and (text.shape[0] == 1 or len(set(g_len.tolist())) > 1),
              f"AR: the stop bias did not stop the rows early at different "
              f"steps: {g_len.tolist()}")
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    for text, pos in batches:
        phase_ar_decode_weight_casts(model, text, pos)

    for (b, name), (ms, (_, lengths)) in sorted(results.items()):
        audio_s = lengths.sum().item() * HOP_SECONDS
        print(f"AR synthesize_transformer_tts B={b} L=128 max_steps "
              f"{MAX_AR_STEPS} bf16 amp, {name}: {ms:.3f} ms/call "
              f"({'median of 3' if name == 'graph' else 'one call'}), "
              f"{ms / MAX_AR_STEPS:.4f} ms per decode step, "
              f"{lengths.sum().item()} frames = {audio_s:.3f} s audio, RTF "
              f"{ms / 1e3 / audio_s:.6f}")
    for text, pos in batches:
        # the profiled call: PROFILE_AR_STEPS groups, timed here (a
        # timing may not follow a profile), its graphs captured here
        ms, _ = wall_ms(lambda: synthesize_transformer_tts(
            model, text, pos, max_steps=PROFILE_AR_STEPS), 3, warmup=1)
        PROFILES.append(partial(profile_ar_synthesis, model, (text, pos),
                                ms))
    del model
    torch.cuda.empty_cache()


PROFILE_AR_STEPS = 100          # decode groups of the profiled AR calls


def profile_ar_synthesis(model, batch, ms_per_call):
    """``print_profile`` of one graphed ``synthesize_transformer_tts`` call
    of PROFILE_AR_STEPS groups, of ``model`` (the AR synthesis phase's,
    its stop bias back at AR_STOP_BIAS, its graphs at that length captured
    there) on ``batch`` (text, positions); then the device operations per
    decode step (all of the call's over its PROFILE_AR_STEPS steps; the
    encoder and postnet add a few dozen), the copy kernels among them, and
    the bf16 weight copies the graph reads in place of as many per-step
    casts."""
    from transformer_tts_tpu_torch.infer import synthesize as synth
    steps = PROFILE_AR_STEPS
    call = partial(synth.synthesize_transformer_tts, model, *batch,
                   max_steps=steps)
    b = batch[0].shape[0]
    ops = print_profile(f"AR graphed synthesis B={b}, one call of {steps} "
                        f"steps", call, 1, ms_per_call)
    per_step = sum(e.count for e in ops) / steps
    copies = sum(e.count for e in ops if "copy" in e.key.lower()) / steps
    slots = sum(len(g.weights.slots)
                for key, g in synth._AR_GRAPHS[model].items()
                if key[0] == b and key[2] == steps)
    print(f"AR graphed synthesis B={b}: {per_step:.1f} device operations "
          f"per decode step, {copies:.1f} of them copy kernels; the graph "
          f"reads {slots} bf16 weight copies (DecodeWeights) instead of "
          f"casting them at every step")


# ---- phase 15: the GST AR Transformer-TTS -----------------------------------

GST_REF_FRAMES = (400, 650)     # the reference mels' frames
GST_SCALE = 10.0


def gst_model(device, amp: bool, seed: int = 0):
    """The GST AR flagship in eval mode, random weights from ``seed``, the
    style token attention's query weights and the tokens scaled by
    GST_SCALE: at the random init the ten tokens' scores lie within ~1e-3
    of each other, so every reference would give one style to bf16's
    precision; scaled, the style follows the reference."""
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    hp = gst_hparams(amp=amp)
    model = build_transformer_tts(hp, device=device, seed=seed).eval()
    with torch.no_grad():
        tokens = model.style_embedding.style_token_layer
        tokens.attention.q_linear.weight.mul_(GST_SCALE)
        tokens.embeddings.mul_(GST_SCALE)
    return hp, model


def phase_gst_synthesis(gen):
    """synthesize_transformer_tts of the GST flagship (bf16 amp, 500 decode
    steps, the stop bias at AR_STOP_BIAS) at B=1 and B=8, styled by a
    (1, 400, 80) reference mel that broadcasts over the batch, counted
    from 0: no kernel launched (the reference goes into the encoder, the
    decode replays its CUDA graph); the graph's mel and lengths bit for
    bit the eager loop's; a second reference mel (650 frames) gives
    another mel; ms per call (median of 3 after the capture) and per
    decode step, RTF."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        MAX_AR_STEPS, synthesize_transformer_tts)
    hp, model = gst_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    refs = [torch.randn(1, n, hp.mel_dim, generator=gen).to(DEVICE)
            for n in GST_REF_FRAMES]
    frames = MAX_AR_STEPS * hp.reduction_rate
    set_counts({})                          # the path starts here
    for batch in AR_SYNTH_BATCHES:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        call = partial(synthesize_transformer_tts, model,
                       text.long().to(DEVICE), pos.to(DEVICE))
        ms, (mel, lengths) = wall_ms(lambda: call(ref_mel=refs[0]), 3,
                                     warmup=1)
        e_mel, e_len = call(ref_mel=refs[0], eager=True)
        other, _ = call(ref_mel=refs[1])
        torch.cuda.synchronize()
        check(mel.shape == (batch, frames, hp.mel_dim)
              and bool(torch.isfinite(mel).all())
              and bool((lengths == frames).all()),
              f"GST synthesis: mel {tuple(mel.shape)}, lengths "
              f"{lengths.tolist()}")
        check(torch.equal(mel, e_mel) and torch.equal(lengths, e_len),
              f"GST B={batch}: the graph's mel differs from the eager "
              f"loop's")
        moved = (mel - other).abs().max().item()
        check(moved > 0, f"GST B={batch}: two reference mels gave one mel")
        audio_s = lengths.sum().item() * HOP_SECONDS
        print(f"GST synthesize_transformer_tts B={batch} L=128 ref_mel "
              f"(1, {GST_REF_FRAMES[0]}, {hp.mel_dim}) max_steps "
              f"{MAX_AR_STEPS} bf16 amp, graph: {ms:.3f} ms/call (median of "
              f"3), {ms / MAX_AR_STEPS:.4f} ms per decode step, "
              f"{lengths.sum().item()} frames = {audio_s:.3f} s audio, RTF "
              f"{ms / 1e3 / audio_s:.6f}; bit for bit the eager loop's; the "
              f"{GST_REF_FRAMES[1]}-frame reference moves the mel by up to "
              f"{moved:.3g}")
    launched = read_counts()                # and ends here
    check(not any(launched.values()),
          f"GST synthesis launched a kernel: {launched}")
    del model
    torch.cuda.empty_cache()


# ---- phase 16: the SQ-VAE FastSpeech 2 --------------------------------------

SQ_STACKS = {"model": "SQFastSpeech2"}


def phase_sq_forward(gen):
    """The SQ-VAE FastSpeech 2's eval forward (B=2, L=128, 768 frames,
    durations predicted from the quantized encoder output, pitch and
    energy targets): card fp32 against CPU fp32 at 1e-3 of max(1,
    max|ref|) on mel_post and the log durations, mel_len equal. Where the
    card's nearest code differs from the CPU's at a tie (``argmin_ties``)
    it takes the CPU's; those rows are counted, and any other difference
    fails."""
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    hp, cpu_model = flagship_model("cpu", amp=False, stacks=SQ_STACKS)
    text, pos = text_batch(gen, 2, 128, 100, hp.vocab_size)
    t = 768
    p = torch.rand(2, t, generator=gen) * 740 + 60
    e = torch.rand(2, t, generator=gen) * 315
    inputs = (text, pad_mask(pos), t, None, p, e)
    codes = []
    with torch.no_grad(), argmin_ties(record=codes):
        ref = cpu_model(*inputs)
    del cpu_model
    _, model = flagship_model(DEVICE, amp=False, stacks=SQ_STACKS)
    cuda_inputs = [x.to(DEVICE) if torch.is_tensor(x) else x for x in inputs]
    with torch.no_grad(), argmin_ties(follow=codes) as ties:
        out = model(*cuda_inputs)
    check(ties[2] == 0, f"SQ eval forward: {ties[2]} codebook rows took "
                        f"another code on the card, beyond a tie")
    check(torch.equal(out.mel_len.cpu(), ref.mel_len),
          f"SQ eval forward: mel_len {out.mel_len.tolist()} vs "
          f"{ref.mel_len.tolist()}")
    errs = {"mel_post": max(
        (out.mel_post[b, :n].cpu() - ref.mel_post[b, :n]).abs().max().item()
        for b, n in enumerate(ref.mel_len.tolist())),
        "log_duration": max_err(out.log_duration.cpu(), ref.log_duration)[0]}
    peak = max(ref.mel_post.abs().max().item(),
               ref.log_duration.abs().max().item())
    tol = 1e-3 * max(1.0, peak)
    print(f"SQ eval forward B=2 L=128 T={t} card fp32 vs CPU fp32: "
          + ", ".join(f"max|d {k}| = {v:.3g}" for k, v in errs.items())
          + f" (tol {tol:.3g}, max|ref| {peak:.3g}, frames "
          f"{ref.mel_len.tolist()}); codebook rows at a tie (within "
          f"{ARGMIN_TIE:g} of the distance) where the card took the CPU's "
          f"code: {ties[0]} of {sum(len(i) for _, i in codes)}, the largest "
          f"gap {ties[1]:.3g}")
    check(all(v <= tol for v in errs.values()),
          "SQ: card fp32 eval forward disagrees with the CPU")
    del model
    torch.cuda.empty_cache()


@contextmanager
def fixed_gumbel(gen):
    """The SQ-VAE's Gumbel noise drawn once per shape on the CPU from
    ``gen`` and handed to every call, on any device, within the block: the
    card's step and the CPU's see the same noise."""
    from transformer_tts_tpu_torch.models import sq_vae
    real, drawn = sq_vae.gumbel_noise, {}

    def fixed(shape, device, generator):
        key = tuple(shape)
        if key not in drawn:
            drawn[key] = real(key, "cpu", gen)
        return drawn[key].to(device)

    sq_vae.gumbel_noise = fixed
    try:
        yield
    finally:
        sq_vae.gumbel_noise = real


def run_clis(runs: dict) -> dict:
    """Start every ``name: argv`` (a module of the repo and its arguments)
    at once, as subprocesses, each with its share of the CPU cores as its
    OpenMP threads; wait for all; each must exit 0. Returns {name:
    stdout}."""
    t0 = time.perf_counter()
    # the cores shared out, so no process's CPU threads spin on another's
    env = dict(os.environ, OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // len(runs))))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, argv in runs.items()}
    outs, walls = {}, {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        walls[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"{name}: exit {proc.returncode}: "
                                    f"{err[-2000:]}")
        outs[name] = out
    print(f"{len(runs)} CLIs at once, seconds until each was collected: "
          + ", ".join(f"{name} {sec:.1f}" for name, sec in walls.items()))
    return outs


def prepare_sq_clis(gen) -> dict:
    """The training and averaging CLIs of ``phase_sq_clis`` (a synthetic
    corpus of CLI_CORPUS, their hparams): {"runs": {name: argv},
    "average": {name: argv}, "work", "script", "hp"}; ``phase_clis`` runs
    them with the others."""
    work = os.path.join(WORK, "sq_clis")
    hp = train_hparams()
    script = write_train_corpus(gen, hp, os.path.join(work, "corpus"))
    cases = {"sq": (SQ_STACKS, []), "transformer": ({}, []),
             "use_sq_vae": ({"use_sq_vae": True}, ["--max_steps", "1"])}
    runs = {}
    for name, (extra, flags) in cases.items():
        hp_file = os.path.join(work, f"{name}.py")
        with open(hp_file, "w") as fh:
            for key, value in dict(FLAGSHIP, **extra, train_script=script,
                                   save_dir=os.path.join(work, name),
                                   batch_size=CLI_CORPUS[2], max_epoch=2,
                                   save_per_epoch=10,
                                   num_workers=CLI_WORKERS).items():
                fh.write(f"{key} = {value!r}\n")
        runs[name] = ["transformer_tts_tpu_torch.cli.train", "--hp_file",
                      hp_file, "--device", DEVICE, *flags]
    average = {f"{name} average": [
        "transformer_tts_tpu_torch.cli.average_checkpoints", "--save_dir",
        os.path.join(work, name), "--last", "2"]
        for name in ("sq", "transformer")}
    return dict(runs=runs, average=average, work=work, script=script, hp=hp)


def phase_sq_clis(sq: dict, outs: dict):
    """Of the runs ``prepare_sq_clis`` made, ``outs`` their output:
    cli/train.py on a synthetic corpus for two epochs, a save each, for
    the SQ-VAE FastSpeech 2 and the transformer flagship, and for one step
    of a use_sq_vae FastSpeech 2 (run at once with the other training
    CLIs); then cli/average_checkpoints.py --last 2 on both two-epoch
    runs (with the other synthesis CLIs), each average equal to the
    float64 mean of its two epochs' state_dicts (the integer buffers the
    newest epoch's); then cli/synthesize.py on the transformer flagship's
    average, started here and collected by ``finish_sq_clis``."""
    work, script, hp = sq["work"], sq["script"], sq["hp"]
    for name in sq["runs"]:
        steps = [ln for ln in outs[name].splitlines()
                 if ln.startswith("epoch ") and " step " in ln]
        check(steps and all("nan" not in ln for ln in steps),
              f"{name} train CLI logged no step")
        print(f"{name} train CLI: {len(steps)} steps, the last: "
              f"{steps[-1][:160]}")
    check("sq_vae_loss=" in outs["use_sq_vae"] and "sq_vae_loss=" in
          outs["sq"], "the SQ train CLIs logged no sq_vae_loss")
    for name in ("sq", "transformer"):
        save_dir = os.path.join(work, name)
        epochs = [torch.load(os.path.join(save_dir, f"epoch_{e}",
                                          "model.pt"), weights_only=True)
                  for e in (1, 2)]
        avg = torch.load(os.path.join(save_dir, "average_epoch1-epoch2",
                                      "model.pt"), weights_only=True)
        check(sorted(avg) == sorted(epochs[1]),
              f"{name}: the average's keys differ")
        moved = 0
        for key, value in avg.items():
            a, b = epochs[0][key], epochs[1][key]
            want = (((a.double() + b.double()) / 2).to(a.dtype)
                    if a.is_floating_point() else b)
            check(torch.equal(value, want), f"{name}: averaged {key} is not "
                                            f"the mean of the two epochs'")
            moved += a.is_floating_point() and not torch.equal(a, b)
        print(f"{name}: {outs[f'{name} average'].strip()}; {len(avg)} "
              f"tensors, each the "
              f"float64 mean of epochs 1 and 2 ({moved} of them differ "
              f"between the epochs), integer buffers epoch 2's")
    test_script = os.path.join(work, "test.txt")
    with open(script) as src, open(test_script, "w") as dst:
        dst.write("".join(src.readlines()[:3]))
    out_dir = os.path.join(work, "generated")
    load_dir = os.path.join(work, "transformer", "average_epoch1-epoch2")
    # its process runs beside 16(a)-(d); ``finish_sq_clis`` collects it
    proc = subprocess.Popen(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.synthesize",
         "--load_name", load_dir, "--test_script", test_script, "--save",
         out_dir, "--max_frames", "2048", "--device", DEVICE], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return dict(proc=proc, out_dir=out_dir, load_dir=load_dir, hp=hp)


def finish_sq_clis(run: dict):
    """The synthesis CLI on the transformer flagship's average that
    ``phase_sq_clis`` started: exit 0 and 3 finite mels."""
    out, err = run["proc"].communicate(timeout=600)
    check(run["proc"].returncode == 0, f"synthesis CLI on the average: exit "
                                       f"{run['proc'].returncode}: "
                                       f"{err[-2000:]}")
    frames = []
    for i in range(3):
        mel = np.load(os.path.join(run["out_dir"], f"{i}.npy"))
        frames.append(mel.shape[0])
        check(mel.ndim == 2 and mel.shape[1] == run["hp"].mel_dim
              and mel.shape[0] > 0 and bool(np.isfinite(mel).all()),
              f"synthesis from the average: mel {i} {mel.shape}")
    print(f"synthesis CLI on {os.path.relpath(run['load_dir'], ROOT)}: 3 "
          f"mels of {frames} frames")


# ---- phase 7: the kernels at their main paths' inputs -----------------------

def attended_pairs(t_q: int, k_len, causal: bool) -> float:
    """The (query row, key) pairs the attention computes for these
    inputs: T_q * sum_b k_len[b], or with ``causal`` sum_b sum_{r<T_q}
    min(r + 1, k_len[b]) -- about half."""
    kl = k_len.double()
    if not causal:
        return t_q * kl.sum().item()
    rows = torch.arange(1, t_q + 1, dtype=torch.float64, device=kl.device)
    return torch.minimum(rows[None, :], kl[:, None]).sum().item()


def sdpa_mask(t_q: int, t_k: int, k_len, causal: bool):
    """The boolean mask of the SDPA yardstick: keys < k_len[b], and with
    ``causal`` keys <= the row (the decoder's pad-and-causal mask)."""
    cols = torch.arange(t_k, device=k_len.device)
    mask = (cols[None, :] < k_len[:, None])[:, None, None, :]
    if causal:
        rows = torch.arange(t_q, device=k_len.device)
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    return mask


def train_kernel_timings(fwd_inputs, bwd_inputs, causal=False) -> dict:
    """The training kernels at the train step's captured input -- the
    FastSpeech 2 step's K1-d-90 and K2-90 (the Hopper design it runs) or,
    with ``causal``, the AR step's K3-d-90 and K3-90 and, in the same run,
    the simple design's forward and dq and dk/dv pair on the same input
    (K1-d, K2-dq, K2-dkdv; K3-d, K3-dq, K3-dkdv: the A/B): kernel, plain
    and library ms, the bound, and each kernel against its fp32 plain
    version there (``check_train_kernels``: O, dq, dk and dv within 2e-2
    of their own max |ref| in bf16), with the O the step's forward gave
    equal bit for bit to a second launch on the same seed.
    The library calls are SDPA with the key mask (with ``causal`` the
    pad-and-causal mask) and the same dropout rate, forward and backward
    (the backward one gives dq, dk and dv together, the yardstick of every
    backward entry). The bounds count the (row, key) pairs these inputs
    attend (``attended_pairs``)."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    counts = read_counts()
    (q, k, v, k_len), fkw = fwd_inputs
    (bq, bk, bv, o, lse, do, bk_len), bkw = bwd_inputs
    rate, seed = fkw["dropout_rate"], fkw["dropout_seed"]
    check(all(torch.equal(x, y) for x, y in ((q, bq), (k, bk), (v, bv),
                                            (k_len, bk_len)))
          and (bkw["dropout_rate"], bkw["dropout_seed"]) == (rate, seed)
          and fkw.get("causal", False) == causal
          and bkw.get("causal", False) == causal,
          "the captured backward is not the captured forward's")
    sm_scale = q.shape[-1] ** -0.5
    b, h, t_q, d = q.shape
    mask = sdpa_mask(t_q, k.shape[2], k_len.clamp(max=k.shape[2]), causal)
    pairs = attended_pairs(t_q, k_len.clamp(max=k.shape[2]), causal)
    el = q.element_size()
    klen_bytes = k_len.numel() * 4
    fwd_bound = bound_ms(4 * h * pairs * d,
                         (2 * q.numel() + k.numel() + v.numel()) * el
                         + b * h * t_q * 4 + klen_bytes, q.dtype)  # o, lse
    # read: q, k, v, dO, lse, delta, k_len; written: dq (bf16), dk, dv
    in_bytes = ((q.numel() + k.numel() + v.numel() + do.numel()) * el
                + 2 * b * h * t_q * 4 + klen_bytes)
    dkdv_bytes = (k.numel() + v.numel()) * el
    pair_bound = bound_ms(10 * h * pairs * d,
                          in_bytes + q.numel() * el + dkdv_bytes, q.dtype)
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)
    bkw = dict(kw, causal=causal)
    res, fwd_ids = {}, []
    with torch.no_grad():
        library_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, scale=sm_scale))
        plain_fwd = time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, k_len, sm_scale, rate, seed, causal))
        delta = fa.bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, k_len)
        plain_dq = time_ms(lambda: fa.flash_attention_dq_reference(
            *args, sm_scale, rate, seed, causal))
        plain_dkdv = time_ms(lambda: fa.flash_attention_dkdv_reference(
            *args, sm_scale, rate, seed, causal))
        for design in ("sm90", "simple"):
            errs, peaks, o_again = check_train_kernels(
                q, k, v, do, k_len, rate, seed, " (train step input)",
                causal=causal, design="simple" if design == "simple"
                else None)
            if design == "sm90":                # what the step itself ran
                check(torch.equal(o_again, o),
                      f"{design}: another O on the same input and seed than "
                      f"in the train step")
            fwd_id, ids = train_kernel_ids(design, causal, rate)
            fwd_ids.append(fwd_id)
            if design == "simple":
                fwd_call = partial(simple_flash_attention, q, k, v, k_len,
                                   causal=causal, **kw)
            else:
                fwd_call = partial(fa.flash_attention, q, k, v, k_len,
                                   dropout_rate=rate, dropout_seed=seed,
                                   causal=causal)
            res[fwd_id] = {
                "ms": time_ms(fwd_call), "plain_ms": plain_fwd,
                "library_ms": library_fwd, "max_abs_err": errs["o"],
                "max_abs_ref": peaks["o"]}
            res[fwd_id]["bound_ms"], res[fwd_id]["bound_by"] = fwd_bound
            print(f"{fwd_id}/{'/'.join(ids)} vs plain at the train step's "
                  f"input: " + " ".join(
                      f"max|d{n}|={e:.3g} (max|ref| {peaks[n]:.3g})"
                      for n, e in errs.items()))
            if design == "sm90":
                res[ids[0]] = {
                    "ms": time_ms(lambda: fa.flash_attention_bwd_sm90(
                        *args, **bkw)),
                    "plain_ms": plain_dq + plain_dkdv,
                    **worst_err(errs, peaks, ("dq", "dk", "dv"))}
                res[ids[0]]["bound_ms"], res[ids[0]]["bound_by"] = (
                    pair_bound)
                continue
            dq_id, dkdv_id = ids
            res[dq_id] = {
                "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args,
                                                                **bkw)),
                "plain_ms": plain_dq,
                "max_abs_err": errs["dq"], "max_abs_ref": peaks["dq"]}
            res[dq_id]["bound_ms"], res[dq_id]["bound_by"] = bound_ms(
                6 * h * pairs * d, in_bytes + q.numel() * el, q.dtype)
            res[dkdv_id] = {
                "ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(*args,
                                                                  **bkw)),
                "plain_ms": plain_dkdv,
                **worst_err(errs, peaks, ("dk", "dv"))}
            res[dkdv_id]["bound_ms"], res[dkdv_id]["bound_by"] = bound_ms(
                8 * h * pairs * d, in_bytes + dkdv_bytes, q.dtype)
        rate0 = time_ms(lambda: fa.flash_attention(q, k, v, k_len,
                                                   causal=causal))
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        dropout_p=rate, scale=sm_scale)
    library_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    for kid in res:
        if kid not in fwd_ids:
            res[kid]["library_ms"] = library_bwd
    set_counts(counts)
    (fwd90, (bwd90,)), (fwd, pair) = (train_kernel_ids(x, causal, rate)
                                      for x in ("sm90", "simple"))
    simple_pair = res[pair[0]]["ms"] + res[pair[1]]["ms"]
    print(f"A/B at the {'AR' if causal else 'FastSpeech 2'} train step's "
          f"input {tuple(q.shape)} rate {rate}: forward, Hopper design "
          f"({fwd90}) {res[fwd90]['ms']:.4f} ms against the simple design "
          f"({fwd}) {res[fwd]['ms']:.4f} ms "
          f"({res[fwd]['ms'] / res[fwd90]['ms']:.2f}x), SDPA "
          f"{library_fwd:.4f} ms, bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}); "
          f"{train_kernel_ids('sm90', causal, 0.0)[0]} at rate 0 "
          f"{rate0:.4f} ms; backward, fused ({bwd90}) "
          f"{res[bwd90]['ms']:.4f} ms against the simple pair "
          f"{simple_pair:.4f} ms ({simple_pair / res[bwd90]['ms']:.2f}x), "
          f"SDPA backward {library_bwd:.4f} ms, bound of the five products "
          f"{pair_bound[0]:.4f} ms ({pair_bound[1]}); saving per decoder "
          f"layer {res[fwd]['ms'] - res[fwd90]['ms'] + simple_pair - res[bwd90]['ms']:.4f} ms")
    return res


def relpos_train_kernel_timings(fwd_inputs, bwd_inputs) -> dict:
    """The relative kernels at the conformer train step's captured input
    (the first decoder layer): K4-d-90 and the fused K5-90 (the Hopper
    design it runs) and, in the same run, the simple design's K4-d, K5-dq
    and K5-dkdv on the same input (the A/B): kernel, plain and library
    ms, the bound, and each design against its fp32 plain version there
    (``check_relpos_train_kernels``), with the O the step's forward gave
    equal bit for bit to a second launch on the same seed. Library: SDPA
    with the relative bias precomputed and the same dropout for the
    forwards; for the backwards SDPA's backward with that bias requiring
    grad, plus the rel_shift adjoint of dbias and the two products that
    take it to dq_v and dP, each part timed, their sum the yardstick of
    every backward entry. Bounds per attended (row, key) pair: the forward 6*H*d, K5-dq
    10*H*d, K5-dkdv 12*H*d, the fused K5-90 16*H*d operations, against
    the bytes moved once."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    counts = read_counts()
    (q_u, q_v, k, v, p, k_len), fkw = fwd_inputs
    (bq_u, bq_v, bk, bv, bp, o, lse, do, bk_len), bkw = bwd_inputs
    rate, seed = fkw["dropout_rate"], fkw["dropout_seed"]
    check(all(torch.equal(x, y) for x, y in ((q_u, bq_u), (q_v, bq_v),
                                            (k, bk), (v, bv), (p, bp),
                                            (k_len, bk_len)))
          and (bkw["dropout_rate"], bkw["dropout_seed"]) == (rate, seed),
          "the captured relative backward is not the captured forward's")
    checked = {}
    for design in ("sm90", "simple"):
        checked[design] = check_relpos_train_kernels(
            q_u, q_v, k, v, p, do, k_len, rate, seed,
            f" (train step input, {design})",
            design=None if design == "sm90" else "simple")
    check(torch.equal(checked["sm90"][2], o), "K4-d-90 gave another O on "
                                              "the same input and seed "
                                              "than in the train step")
    sm_scale = q_u.shape[-1] ** -0.5
    b, h, t, d = q_u.shape
    pairs = attended_pairs(t, k_len, False)
    el = q_u.element_size()
    plane = q_u.numel() * el
    in_bytes = 5 * plane + p.numel() * el + 2 * b * h * t * 4
    bias = relpos_bias(q_v, p, k_len, sm_scale)
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)
    fwd_bound = bound_ms(6 * h * pairs * d,
                         5 * plane + p.numel() * el + b * h * t * 4,
                         q_u.dtype)
    pair_bound = bound_ms(16 * h * pairs * d,
                          in_bytes + 4 * plane + p.numel() * el, q_u.dtype)
    res = {}
    with torch.no_grad():
        plain_fwd = time_ms(lambda: fr.flash_relpos_attention_fwd_reference(
            q_u, q_v, k, v, p, k_len, sm_scale, rate, seed))
        library_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q_u, k, v, attn_mask=bias, dropout_p=rate, scale=sm_scale))
        rate0 = {}
        for kid, design, call in (
                ("K4-d-90", "sm90", fr.flash_relpos_attention),
                ("K4-d", "simple", partial(simple_flash_relpos_attention,
                                           sm_scale=sm_scale))):
            errs, peaks, _ = checked[design]
            res[kid] = {
                "ms": time_ms(lambda: call(q_u, q_v, k, v, p, k_len,
                                           dropout_rate=rate,
                                           dropout_seed=seed)),
                "plain_ms": plain_fwd, "library_ms": library_fwd,
                "max_abs_err": errs["o"], "max_abs_ref": peaks["o"]}
            res[kid]["bound_ms"], res[kid]["bound_by"] = fwd_bound
            rate0[kid] = time_ms(lambda: call(q_u, q_v, k, v, p, k_len))

        args = (q_u, q_v, k, v, p, do, lse, fr.bwd_delta(o, do), k_len)
        errs, peaks, _ = checked["sm90"]
        res["K5-90"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_sm90(
                *args, **kw)),
            "plain_ms": time_ms(
                lambda: fr.flash_relpos_attention_bwd_reference(
                    q_u, q_v, k, v, p, o, lse, do, k_len, sm_scale, rate,
                    seed)),
            **worst_err(errs, peaks, RELPOS_GRADS)}
        res["K5-90"]["bound_ms"], res["K5-90"]["bound_by"] = pair_bound
        errs, peaks, _ = checked["simple"]
        res["K5-dq"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_dq(*args,
                                                                   **kw)),
            "plain_ms": time_ms(lambda: fr.flash_relpos_dq_reference(
                *args, sm_scale, rate, seed)),
            **worst_err(errs, peaks, ("dq_u", "dq_v"))}
        res["K5-dq"]["bound_ms"], res["K5-dq"]["bound_by"] = bound_ms(
            10 * h * pairs * d, in_bytes + 2 * plane, q_u.dtype)
        res["K5-dkdv"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_dkdv(*args,
                                                                     **kw)),
            "plain_ms": time_ms(lambda: fr.flash_relpos_dkdv_reference(
                *args, sm_scale, rate, seed)),
            **worst_err(errs, peaks, ("dk", "dv", "dp"))}
        res["K5-dkdv"]["bound_ms"], res["K5-dkdv"]["bound_by"] = bound_ms(
            12 * h * pairs * d, in_bytes + 2 * plane + p.numel() * el,
            q_u.dtype)
    lq, lk, lv, lbias = (x.detach().clone().requires_grad_()
                         for x in (q_u, k, v, bias))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lbias,
                                        dropout_p=rate, scale=sm_scale)
    parts = {"sdpa_bwd": time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv, lbias), do, retain_graph=True))}
    dbias = torch.autograd.grad(lo, lbias, do, retain_graph=True)[0]
    with torch.no_grad():
        parts["rel_shift_adjoint"] = time_ms(
            lambda: fr.rel_shift_adjoint(dbias))
        g = fr.rel_shift_adjoint(dbias)
        parts["products"] = time_ms(lambda: (
            torch.matmul(g, p), torch.einsum("bhij,bhid->hjd", g, q_v)))
    for kid in ("K5-90", "K5-dq", "K5-dkdv"):
        res[kid]["library_ms"] = sum(parts.values())
    set_counts(counts)
    for design, (errs, peaks, _) in checked.items():
        print(f"K4-d/K5 {design} vs plain at the conformer train step's "
              "input: " + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                   f"{peaks[n]:.3g})" for n, e in errs.items())
              + ("; O equal to the step's" if design == "sm90" else ""))
    print(f"A/B at the conformer train step's first decoder layer, rate "
          f"{rate}: K4-d-90 {res['K4-d-90']['ms']:.4f} ms against the simple "
          f"K4-d {res['K4-d']['ms']:.4f} ms "
          f"({res['K4-d']['ms'] / res['K4-d-90']['ms']:.2f}x); at rate 0 "
          f"K4-90 {rate0['K4-d-90']:.4f} ms against K4 {rate0['K4-d']:.4f} "
          f"ms; SDPA with the bias built {library_fwd:.4f} ms")
    simple_pair = res["K5-dq"]["ms"] + res["K5-dkdv"]["ms"]
    print(f"A/B of K5 at that input: the fused K5-90 {res['K5-90']['ms']:.4f} "
          f"ms against the simple pair K5-dq + K5-dkdv {simple_pair:.4f} ms "
          f"({simple_pair / res['K5-90']['ms']:.2f}x); the bound of the "
          f"pair {pair_bound[0]:.4f} ms ({pair_bound[1]}); library yardstick "
          + " + ".join(f"{n} {v:.4f}" for n, v in parts.items())
          + f" = {sum(parts.values()):.4f} ms")
    return res


def relpos_route(route: int, q_u, q_v, k, v, p, k_len, rate, seed):
    """The conformer's relative attention core, (o, lse): route 1 the
    relative kernels (K4/K4-d, and K5 behind autograd: in bf16 the Hopper
    design's K4-90/K4-d-90 and K5-90); route 2 the bias
    rel_shift(q_v P^T) built in device memory (unscaled, unmasked, in
    q_v's dtype), then K6/K6-d (and K6's backward, the bias's gradient
    going back through rel_shift and the product by autograd)."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    if route == 1:
        return fr.flash_relpos_attention(q_u, q_v, k, v, p, k_len, **kw)
    return fa.flash_attention_with_bias(q_u, k, v, relpos_route_bias(q_v, p),
                                        k_len, **kw)


def bias_kernel_timings(fwd_inputs, bwd_inputs) -> tuple:
    """K6 at the conformer train step's captured input (the first decoder
    layer: q_u, q_v, k, v, P, the batch's mel lengths, dropout 0.1 on the
    step's seed, dO from its backward), with the bias of route 2.

    The path that launches K6 is chip_smoke's route A/B: route 2 once
    forward at rate 0 (1 K6-90) and once forward and backward at the
    step's rate (1 K6-d-90, 1 K6-bwd-90), counted from 0, nothing else
    launched. Then each design against its fp32 plain version at that
    input (``check_bias_kernels``) and its kernel, plain and library ms
    and bound -- the Hopper design's K6-90, K6-d-90 and fused K6-bwd-90,
    and on the same input the simple design's K6, K6-d, K6-dq and K6-dkdv
    (the same-run A/B). Operations per attended (row, key) pair 4*H*d
    forward, 10*H*d the fused backward, 6*H*d dq, 8*H*d dk/dv; bytes q,
    k, v (and dO, lse, delta) read once, the bias read over the valid
    keys, o (dq, dk and dv) written once, dbias written whole. Library:
    SDPA with relpos_bias (the bias scaled and -inf-filled past k_len) as
    its mask, with the step's dropout for K6-d; for the backward entries
    SDPA's backward with the mask's gradient. Last the A/B of the two
    routes, forward and forward+backward. That the routes compute the
    same function is held in fp32, both routes on the card on the input's
    values: O and all five gradients of route 2 within 2e-2 of route 1's
    own max|ref|. In bf16 each route's differences from route 1's fp32
    results are printed: the conformer's gradients there are ~1e-7 sums
    that cancel, and a bf16 rounding of O moves delta = rowsum(dO O) in
    each route's backward by a few percent of them. Returns ({id:
    result}, {id: launches})."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    (q_u, q_v, k, v, p, k_len), fkw = fwd_inputs
    do = bwd_inputs[0][7]
    rate, seed = fkw["dropout_rate"], fkw["dropout_seed"]
    names = ("o",) + tuple(f"d{n}" for n in ("q_u", "q_v", "k", "v", "p"))
    xs = [x.detach().clone().requires_grad_() for x in (q_u, q_v, k, v, p)]
    xs32 = [x.detach().float().requires_grad_() for x in xs]

    def fwd_bwd(route, leaves=xs):
        o, _ = relpos_route(route, *leaves, k_len, rate, seed)
        return (o, *torch.autograd.grad(o, leaves, do.to(o.dtype)))

    set_counts({})                          # the path starts here
    with torch.no_grad():
        relpos_route(2, q_u, q_v, k, v, p, k_len, 0.0, 0)
    bf16_2 = fwd_bwd(2)
    torch.cuda.synchronize()
    launches = read_counts()                # and ends here
    want = {kid: 0 for kid in counters()}
    want.update({kid: 1 for kid in ("K6-90", "K6-d-90", "K6-bwd-90")})
    check(launches == want, f"the route A/B's K6 launches {launches}, "
                            f"expected {want}")
    counts = read_counts()
    bf16_1 = fwd_bwd(1)
    fp32_1, fp32_2 = fwd_bwd(1, xs32), fwd_bwd(2, xs32)
    torch.cuda.synchronize()
    agree = {}
    for name, r1, r2, x1, x2 in zip(names, fp32_1, fp32_2, bf16_1, bf16_2):
        peak = r1.abs().max().item()
        agree[name] = (max_err(r2, r1)[0] / peak,
                       max_err(x1, r1)[0] / peak, max_err(x2, r1)[0] / peak)
        check(agree[name][0] <= 2e-2,
              f"the two conformer routes disagree on {name} in fp32: "
              f"{agree[name][0]:.3g} of max|ref| {peak:.3g}")

    sm_scale = q_u.shape[-1] ** -0.5
    b, h, t, d = q_u.shape
    with torch.no_grad():
        bias = relpos_route_bias(q_v, p)
        checked = {}
        for design in ("sm90", "simple"):
            for r, sd in ((0.0, 0), (rate, seed)):
                checked[design, r] = check_bias_kernels(
                    q_u, k, v, bias, do, k_len, r, sd,
                    f" (conformer step input, {design})",
                    design=None if design == "sm90" else "simple")
    pairs = attended_pairs(t, k_len, False)
    el = q_u.element_size()
    plane = q_u.numel() * el
    bias_in = h * pairs * el                # the bias over the valid keys
    dbias_out = bias.numel() * el           # dbias written whole
    stats = b * h * t * 4
    in_bytes = 4 * plane + 2 * stats + bias_in  # q, k, v, dO, lse, delta
    fwd_bound = bound_ms(4 * h * pairs * d, 4 * plane + bias_in + stats,
                         q_u.dtype)
    mask = relpos_bias(q_v, p, k_len, sm_scale)
    res = {}
    with torch.no_grad():
        library_fwd = {r: time_ms(lambda: F.scaled_dot_product_attention(
            q_u, k, v, attn_mask=mask, dropout_p=r, scale=sm_scale))
            for r in (0.0, rate)}
        plain_fwd = {r: time_ms(lambda: fa.flash_attention_fwd_reference(
            q_u, k, v, k_len, sm_scale, r, seed, bias=bias))
            for r in (0.0, rate)}
        for design in ("sm90", "simple"):
            for r in (0.0, rate):
                kid = bias_kernel_ids(design, r)[0]
                e, pk, _ = checked[design, r]
                res[kid] = {
                    "ms": time_ms(lambda: fa._forward(
                        q_u, k, v, k_len, sm_scale, r, seed, False, bias,
                        design=None if design == "sm90" else "simple")),
                    "plain_ms": plain_fwd[r], "library_ms": library_fwd[r],
                    "max_abs_err": e["o"], "max_abs_ref": pk["o"]}
                res[kid]["bound_ms"], res[kid]["bound_by"] = fwd_bound
        o, lse = fa.flash_attention_with_bias(q_u, k, v, bias, k_len,
                                              dropout_rate=rate,
                                              dropout_seed=seed)
        args = (q_u, k, v, do, lse, fa.bwd_delta(o, do), k_len)
        kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
                  bias=bias)
        plain_dq = time_ms(lambda: fa.flash_attention_dq_reference(
            *args, sm_scale, rate, seed, bias=bias))
        plain_dkdv = time_ms(lambda: fa.flash_attention_dkdv_reference(
            *args, sm_scale, rate, seed, bias=bias))
        errs, peaks, _ = checked["sm90", rate]
        res["K6-bwd-90"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_sm90(*args, **kw)),
            "plain_ms": plain_dq + plain_dkdv,
            **worst_err(errs, peaks, BIAS_GRADS)}
        res["K6-bwd-90"]["bound_ms"], res["K6-bwd-90"]["bound_by"] = (
            bound_ms(10 * h * pairs * d,
                     in_bytes + 3 * plane + dbias_out, q_u.dtype))
        errs, peaks, _ = checked["simple", rate]
        res["K6-dq"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw)),
            "plain_ms": plain_dq,
            **worst_err(errs, peaks, ("dq", "dbias"))}
        res["K6-dq"]["bound_ms"], res["K6-dq"]["bound_by"] = bound_ms(
            6 * h * pairs * d, in_bytes + plane + dbias_out, q_u.dtype)
        res["K6-dkdv"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(*args, **kw)),
            "plain_ms": plain_dkdv,
            **worst_err(errs, peaks, ("dk", "dv"))}
        res["K6-dkdv"]["bound_ms"], res["K6-dkdv"]["bound_by"] = bound_ms(
            8 * h * pairs * d, in_bytes + 2 * plane, q_u.dtype)
    lq, lk, lv, lmask = (x.detach().clone().requires_grad_()
                         for x in (q_u, k, v, mask))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask,
                                        dropout_p=rate, scale=sm_scale)
    library_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv, lmask), do, retain_graph=True))
    for kid in ("K6-bwd-90", "K6-dq", "K6-dkdv"):
        res[kid]["library_ms"] = library_bwd

    ab = {}
    with torch.no_grad():
        ab["bias build"] = time_ms(lambda: relpos_route_bias(q_v, p))
        for route in (1, 2):
            ab[f"route {route} forward"] = time_ms(lambda: relpos_route(
                route, q_u, q_v, k, v, p, k_len, rate, seed))
    for route in (1, 2):
        ab[f"route {route} forward+backward"] = time_ms(
            lambda: fwd_bwd(route))
    set_counts(counts)
    for (design, r), (e, pk, _) in checked.items():
        print(f"K6 {design} vs plain at the conformer train step's input, "
              f"bias rel_shift(q_v P^T) {str(q_u.dtype)[6:]}, rate {r}: "
              + " ".join(f"max|d{n}|={x:.3g} (max|ref| {pk[n]:.3g})"
                         for n, x in e.items()))
    print("conformer routes at that input, each difference a share of "
          "route 1's fp32 max|ref|: route 2 against route 1 in fp32 (tol "
          "2e-2); route 1 and route 2 in bf16 against route 1 in fp32: "
          + ", ".join(f"{n} {a:.2e} | {b1:.2e} {b2:.2e}"
                      for n, (a, b1, b2) in agree.items()))
    print("conformer route A/B (route 1: K4-d-90, K5-90 behind autograd; "
          "route 2: the bias in device memory, K6-d-90, K6-bwd-90, the "
          "rel_shift adjoint and the products by autograd), dropout "
          f"{rate}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in ab.items()))
    simple_pair = res["K6-dq"]["ms"] + res["K6-dkdv"]["ms"]
    print(f"A/B of K6 at that input: forward, K6-d-90 "
          f"{res['K6-d-90']['ms']:.4f} ms against the simple K6-d "
          f"{res['K6-d']['ms']:.4f} ms "
          f"({res['K6-d']['ms'] / res['K6-d-90']['ms']:.2f}x), SDPA "
          f"{library_fwd[rate]:.4f} ms; at rate 0 K6-90 "
          f"{res['K6-90']['ms']:.4f} ms against K6 {res['K6']['ms']:.4f} ms, "
          f"SDPA {library_fwd[0.0]:.4f} ms; bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}); backward, fused K6-bwd-90 "
          f"{res['K6-bwd-90']['ms']:.4f} ms against the simple pair "
          f"{simple_pair:.4f} ms ({simple_pair / res['K6-bwd-90']['ms']:.2f}"
          f"x), SDPA backward with the mask's gradient {library_bwd:.4f} "
          f"ms, bound {res['K6-bwd-90']['bound_ms']:.4f} ms "
          f"({res['K6-bwd-90']['bound_by']})")
    return res, launches


def relpos_route_bias(q_v, p):
    """Route 2's bias: rel_shift(q_v P^T), unscaled and unmasked, in q_v's
    dtype, contiguous (K6's input)."""
    from transformer_tts_tpu_torch.ops.flash_relpos import rel_shift
    return rel_shift(torch.matmul(q_v, p.transpose(-1, -2))).contiguous()


def causal_forward_timings(inputs) -> dict:
    """K3-f-90 and, on the same input, the simple design's K3-f (the A/B)
    at their path's captured input (the first decoder layer of the
    teacher-forced bf16 eval forward): kernel, plain and library (SDPA
    with the pad-and-causal mask) ms, the bound over the attended pairs,
    and O's error against the fp32 plain version on the same inputs, with
    O bit for bit on a second launch."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    (q, k, v, k_len), kw = inputs
    check(kw.get("causal") is True and kw.get("dropout_rate", 0.0) == 0.0,
          "the captured eval forward is not K3-f's")
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    b, h, t_q, d = q.shape
    mask = sdpa_mask(t_q, k.shape[2], k_len, True)
    calls = {"K3-f-90": partial(fa.flash_attention, q, k, v, k_len,
                                causal=True),
             "K3-f": partial(simple_flash_attention, q, k, v, k_len,
                             sm_scale=sm_scale, causal=True)}
    bound = bound_ms(4 * h * attended_pairs(t_q, k_len, True) * d,
                     4 * q.numel() * q.element_size() + b * h * t_q * 4,
                     q.dtype)
    out = {}
    with torch.no_grad():
        ro, _ = fa.flash_attention_fwd_reference(
            *(x.float() for x in (q, k, v)), k_len, sm_scale, causal=True)
        plain_ms = time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, k_len, sm_scale, causal=True))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm_scale))
        for kid, call in calls.items():
            o, _ = call()
            again, _ = call()
            err, peak = max_err(o, ro)
            check(torch.equal(o, again) and err <= REL_TOL[q.dtype] * peak,
                  f"{kid} at its path's input: {err} against max|ref| "
                  f"{peak}, or another O on a second launch")
            out[kid] = {"ms": time_ms(call), "plain_ms": plain_ms,
                        "library_ms": library_ms, "max_abs_err": err,
                        "max_abs_ref": peak}
            out[kid]["bound_ms"], out[kid]["bound_by"] = bound
    set_counts(counts)
    print(f"A/B at the AR eval forward's first decoder layer "
          f"{tuple(q.shape)}: K3-f-90 {out['K3-f-90']['ms']:.4f} ms against "
          f"the simple K3-f {out['K3-f']['ms']:.4f} ms "
          f"({out['K3-f']['ms'] / out['K3-f-90']['ms']:.2f}x), SDPA "
          f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return out


# ---- phase 8: attention paths -----------------------------------------------

ATTENTION_PATH_T = (128, 256, 768, 2048)
RELPOS_PATH_T = (128, 256, 512, 1024, 2048)
CAUSAL_PATH_T = (128, 256, AR_GROUPS, 1024, 2048)


def forward_backward_ms(fn, tensors, do) -> float:
    """Device ms of ``fn(*tensors)`` (its first output) and the gradients
    of ``(out * do).sum()`` with respect to every tensor."""
    leaves = [x.detach().clone().requires_grad_() for x in tensors]

    def run():
        out = fn(*leaves)[0]
        torch.autograd.grad(out, leaves, do)
    return time_ms(run)


def phase_attention_paths(gen):
    """Kernel path against masked-fill path at B=8, H=4, d=96 in bf16: the
    transformer's forward (K1-90) at T in ATTENTION_PATH_T; the
    conformer's forward (K4-90) at T in RELPOS_PATH_T; then the AR
    decoder's causal self-attention at T in CAUSAL_PATH_T, forward
    (K3-f-90) and forward with backward (K3-f-90 and K3-90), against the
    masked-fill path on the pad-and-causal mask."""
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops.flash_attention import flash_attention
    from transformer_tts_tpu_torch.ops.flash_relpos import (
        flash_relpos_attention)
    counts = read_counts()
    for t in ATTENTION_PATH_T:
        q, k, v = (x.to(torch.bfloat16) for x in
                   kernel_inputs("K1", gen, 8, 4, t, t, 96))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = torch.ones(8, 1, t, dtype=torch.bool, device=DEVICE)
        times = [time_ms(lambda: flash_attention(q, k, v, k_len)),
                 time_ms(lambda: attention.scaled_dot_attention(q, k, v,
                                                                mask))]
        print(f"attention B=8 H=4 d=96 bf16 T={t}: K1 path (the Hopper "
              f"design) {times[0]:.4f} ms, masked-fill path {times[1]:.4f} "
              f"ms")
    for t in RELPOS_PATH_T:
        q_u, q_v, k, v, p = (x.to(torch.bfloat16) for x in
                             kernel_inputs("K4", gen, 8, 4, t, t, 96))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = torch.ones(8, 1, t, dtype=torch.bool, device=DEVICE)
        times = [time_ms(lambda: flash_relpos_attention(q_u, q_v, k, v, p,
                                                        k_len)),
                 time_ms(lambda: attention.relative_dot_attention(
                     q_u, q_v, k, v, p[None], mask))]
        print(f"relative attention B=8 H=4 d=96 bf16 T={t}: K4 path (the "
              f"Hopper design, K4-90) {times[0]:.4f} ms, relative "
              f"masked-fill path {times[1]:.4f} ms")
    for t in CAUSAL_PATH_T:
        q, k, v, do = (torch.randn(8, 4, t, 96, generator=gen).to(
            DEVICE, torch.bfloat16) for _ in range(4))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = sdpa_mask(t, t, k_len, True)[:, 0]      # (B, T, T)
        kernel = partial(flash_attention, k_len=k_len, causal=True)
        masked = partial(attention.scaled_dot_attention, mask=mask)
        with torch.no_grad():
            fwd = [time_ms(lambda: kernel(q, k, v)),
                   time_ms(lambda: masked(q, k, v))]
        both = [forward_backward_ms(kernel, (q, k, v), do),
                forward_backward_ms(masked, (q, k, v), do)]
        print(f"causal attention B=8 H=4 d=96 bf16 T={t}: forward, K3 path "
              f"(K3-f-90) {fwd[0]:.4f} ms, masked-fill path {fwd[1]:.4f} "
              f"ms; forward and backward, K3 path (K3-f-90 + K3-90) "
              f"{both[0]:.4f} ms, masked-fill path {both[1]:.4f} ms")
    set_counts(counts)


# ---- phases 10-14: features and vocoder -------------------------------------

SAMPLE_RATE = 22050
FEATURE_BATCH = (16, 10.0)    # waveforms, seconds each
VOCODER_MEL_T = 64            # frames of the forward's card-vs-CPU check
DISC_N = 8192                 # samples of the discriminator's check
VOCODED_CASES = ((1, 768), (8, 2048))
GL_ITERS = 32
GAN_BATCH = 16                # the timed GAN step, hp.vocoder_segment_size
GAN_CPU_BATCH = 2
CLI_WAVS = (2.0, 3.5, 2.7, 4.1)   # seconds
VOCODER_TOL = 1e-3            # card fp32 against CPU fp32, of max|ref|


def vocoder_hparams(**overrides):
    from transformer_tts_tpu_torch.config import HParams
    return HParams(**dict(FLAGSHIP, **overrides))


def waveforms(gen, n: int, seconds: float) -> torch.Tensor:
    """(n, seconds * 22050) fp32: a tone of 4 harmonics at random phases,
    its f0 from 80 to 400 Hz by row, noise at 0.01, and a silent stretch
    of 0.3 s in the middle."""
    length = int(seconds * SAMPLE_RATE)
    t = torch.arange(length, dtype=torch.float64) / SAMPLE_RATE
    f0 = torch.linspace(80.0, 400.0, n, dtype=torch.float64)[:, None]
    phase = torch.rand(n, 4, generator=gen, dtype=torch.float64) * 2 * math.pi
    audio = sum(0.3 / (h + 1) * torch.sin(2 * math.pi * f0 * (h + 1) * t
                                          + phase[:, h:h + 1])
                for h in range(4))
    audio = audio + 0.01 * torch.randn(n, length, generator=gen,
                                       dtype=torch.float64)
    mid = length // 2
    audio[:, mid: mid + int(0.3 * SAMPLE_RATE)] = 0.0
    return audio.float()


def phase_features(gen):
    """log_mel_spectrogram, yin_f0 and energy_per_frame on the card against
    the same functions on the CPU, on 16 seeded waveforms of 10 s; times
    per second of audio (CUDA events). Returns the log-mels' corpus
    (mean, var), the de-normalization of the vocoded synthesis."""
    from transformer_tts_tpu_torch.ops.features import energy_per_frame, yin_f0
    from transformer_tts_tpu_torch.ops.melspectrogram import (
        compute_corpus_stats, log_mel_spectrogram)
    n, seconds = FEATURE_BATCH
    audio = waveforms(gen, n, seconds)
    card = audio.to(DEVICE)
    audio_s = n * seconds
    out = {}
    for name, fn in (("log_mel", log_mel_spectrogram), ("yin_f0", yin_f0),
                     ("energy", energy_per_frame)):
        with torch.no_grad():
            got, ref = fn(card).cpu(), fn(audio)
            ms = time_ms(lambda: fn(card), reps=10)
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{name}: card {tuple(got.shape)} against CPU "
              f"{tuple(ref.shape)}, or not finite")
        out[name] = (got, ref, ms)
    got, ref, ms = out["log_mel"]
    err, peak = max_err(got, ref)
    print(f"features B={n} x {seconds} s at {SAMPLE_RATE} Hz, log-mel "
          f"{tuple(got.shape)}: card vs CPU max abs err {err:.3g} (natural "
          f"log, tol 1e-3; max|ref| {peak:.3g}), {ms:.3f} ms = "
          f"{ms / audio_s:.4f} ms per second of audio")
    check(err <= 1e-3, "log-mel: card disagrees with CPU")
    got, ref, ms = out["energy"]
    err, peak = max_err(got, ref)
    print(f"features energy {tuple(got.shape)}: max abs err {err:.3g} "
          f"(tol 1e-4 of max|ref| {peak:.3g}), {ms:.3f} ms = "
          f"{ms / audio_s:.4f} ms per second of audio")
    check(err <= 1e-4 * peak, "energy: card disagrees with CPU")
    got, ref, ms = out["yin_f0"]
    same = (got > 0) == (ref > 0)
    both = (got > 0) & (ref > 0)
    df0 = (got - ref)[both].abs().max().item() if both.any() else 0.0
    print(f"features YIN f0 {tuple(got.shape)}: voicing the same at "
          f"{same.float().mean().item():.5%} of frames (tol 99.9 %), "
          f"{(ref > 0).float().mean().item():.1%} voiced on the CPU, "
          f"max |d f0| {df0:.4g} Hz at frames voiced on both (tol 0.1; "
          f"max f0 {ref.max().item():.1f} Hz), {ms:.3f} ms = "
          f"{ms / audio_s:.4f} ms per second of audio")
    check(same.float().mean().item() >= 0.999 and df0 <= 0.1,
          "YIN: card disagrees with CPU")
    mels = out["log_mel"][1]
    return compute_corpus_stats(mels, torch.full((n,), mels.shape[1]))


def vocoders(device):
    """The three generators of the slice at full width, random weights
    from seed 0, fp32: HiFi-GAN V1 subpixel and transposed, iSTFT."""
    from transformer_tts_tpu_torch.vocoder.trainer import build_vocoder
    kinds = {"HiFi-GAN V1 subpixel": {},
             "HiFi-GAN V1 transposed": {"vocoder_upsample_mode":
                                        "transposed"},
             "iSTFT": {"vocoder_type": "istft"}}
    return {name: build_vocoder(vocoder_hparams(**kw), amp=False,
                                device=device).eval()
            for name, kw in kinds.items()}


def phase_vocoder_forward(gen):
    """Each generator on a (1, 64, 80) mel and the discriminator on a
    (2, 8192) waveform, card fp32 (TF32 off) against CPU fp32, within
    VOCODER_TOL of each output's max|ref|."""
    from transformer_tts_tpu_torch.vocoder.trainer import build_discriminator
    hp = vocoder_hparams()
    mel = torch.randn(1, VOCODER_MEL_T, hp.mel_dim, generator=gen) - 4.0
    card = vocoders(DEVICE)
    for name, cpu_model in vocoders("cpu").items():
        with torch.no_grad():
            ref = cpu_model(mel)
            got = card[name](mel.to(DEVICE)).cpu()
        err, peak = max_err(got, ref)
        print(f"vocoder {name} forward {tuple(mel.shape)} -> "
              f"{tuple(got.shape)}: card fp32 vs CPU fp32 max abs err "
              f"{err:.3g} (tol {VOCODER_TOL:g} of max|ref| {peak:.3g})")
        check(got.shape == (1, VOCODER_MEL_T * 256) and err <= VOCODER_TOL
              * peak, f"vocoder {name}: card disagrees with CPU")
    audio = waveforms(gen, 2, DISC_N / SAMPLE_RATE)[:, :DISC_N]
    disc_cpu = build_discriminator(hp, device="cpu")
    disc = build_discriminator(hp, device=DEVICE)
    with torch.no_grad():
        ref = disc_cpu(audio)
        got = disc(audio.to(DEVICE))
    worst, n_maps = 0.0, 0
    for (logits, fmaps), (rlogits, rfmaps) in zip(got, ref):
        for a, b in [(logits, rlogits)] + list(zip(fmaps, rfmaps)):
            err, peak = max_err(a.cpu(), b)
            worst = max(worst, err / max(peak, 1e-30))
            n_maps += 1
    print(f"discriminator MPD {hp.vocoder_periods} + MSD x"
          f"{hp.vocoder_num_scales} on {tuple(audio.shape)}: logits and "
          f"{n_maps - len(ref)} feature maps, card fp32 vs CPU fp32, worst "
          f"err {worst:.3g} of its own max|ref| (tol {VOCODER_TOL:g})")
    check(worst <= VOCODER_TOL, "discriminator: card disagrees with CPU")


@contextmanager
def cudnn_tf32(enabled: bool):
    """cuDNN's TF32 for convolutions on or off inside (chip_smoke keeps
    it off; the CLIs run with torch's default, on)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def phase_vocoded_synthesis(gen, mean, var):
    """The slice's main path as ``cli/synthesize.py --vocoder`` runs it:
    the transformer FastSpeech 2 flagship (bf16 amp, K1-90) de-normalizes
    its mel by the corpus ``mean`` and ``var``, then each utterance goes
    through HiFi-GAN V1 alone (``vocode_utterance``: padded to a bucket of
    ``hp.length_buckets``, fp32, cut to frames x 256 samples), with
    cuDNN's default TF32 as in the CLI; at B=1 / 768 and B=8 / 2048
    frames, every count set to 0 just before. Timed as one call (host
    clock), and the vocoding alone on the same mels with TF32 off, with
    TF32 and under bf16 autocast (as hp.amp trains it); the acoustic
    model's share is the difference. Then Griffin-Lim at B=1."""
    from transformer_tts_tpu_torch.data.batching import pick_bucket
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2, vocode_utterance)
    from transformer_tts_tpu_torch.ops.melspectrogram import (
        griffin_lim_from_log_mel)
    from transformer_tts_tpu_torch.vocoder.trainer import build_vocoder
    hp, model = flagship_model(DEVICE, amp=True, stacks={})
    vocoder = build_vocoder(vocoder_hparams(), amp=False,
                            device=DEVICE).eval()
    mean, var = mean.to(DEVICE), var.to(DEVICE)
    kid = PATHS["transformer"][1]
    batches = []
    for batch, max_frames in VOCODED_CASES:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        batches.append((text.to(DEVICE), pos.to(DEVICE), max_frames))

    def vocode(mel, mel_len):
        return [vocode_utterance(vocoder, mel[j, :n], hp.length_buckets)
                for j, n in enumerate(mel_len.tolist())]

    def synthesize(text, pos, max_frames):
        mel, mel_len, _ = synthesize_fastspeech2(model, text, pos,
                                                 max_frames, mean, var)
        return mel, mel_len, vocode(mel, mel_len)

    set_counts({})                          # the main path starts here
    per_call = []
    outputs = []
    with cudnn_tf32(True):
        for text, pos, max_frames in batches:
            before = read_counts()
            mel, mel_len, wavs = synthesize(text, pos, max_frames)
            torch.cuda.synchronize()
            per_call.append({k: n - before[k]
                             for k, n in read_counts().items()})
            check(all(w.shape == (n * 256,) and bool(torch.isfinite(w).all())
                      and bool((w.abs() <= 1).all())
                      for w, n in zip(wavs, mel_len.tolist())),
                  "vocoded synthesis: a waveform's length or values")
            outputs.append((mel, mel_len))
    print(f"vocoded synthesis main path: launches per call "
          f"{json.dumps(per_call)} (expect {hp.n_layer_decoder} of {kid} "
          f"each, none of the others)")
    check(all(c[kid] == hp.n_layer_decoder and all(
        n == 0 for k, n in c.items() if k != kid) for c in per_call),
        "vocoded synthesis: kernel launches")

    for (text, pos, max_frames), (mel, mel_len) in zip(batches, outputs):
        b = text.shape[0]
        lens = mel_len.tolist()
        audio_s = sum(lens) * HOP_SECONDS
        padded = sum(pick_bucket(n, hp.length_buckets) for n in lens)
        with cudnn_tf32(True):
            torch.cuda.reset_peak_memory_stats()
            total_ms = wall_ms(lambda: synthesize(text, pos, max_frames), 10,
                               warmup=3)[0]
            total_gb = torch.cuda.max_memory_allocated() / 1e9
        modes = {}
        for label, tf32, amp in (("fp32", False, False),
                                 ("fp32 with cuDNN TF32 (the CLI's)", True,
                                  False), ("bf16 autocast", False, True)):
            vocoder.amp = amp
            with cudnn_tf32(tf32):
                torch.cuda.reset_peak_memory_stats()
                modes[label] = (wall_ms(lambda: vocode(mel, mel_len), 10,
                                        warmup=3)[0],
                                torch.cuda.max_memory_allocated() / 1e9)
        vocoder.amp = False
        voc_ms = modes["fp32 with cuDNN TF32 (the CLI's)"][0]
        print(f"vocoded synthesis B={b} max_frames={max_frames}: "
              f"{sum(lens)} frames = {audio_s:.3f} s audio, vocoded one "
              f"utterance at a time in {padded} bucket-padded frames; "
              f"acoustic model and vocoder as one call (the CLI's TF32) "
              f"{total_ms:.3f} ms (peak {total_gb:.2f} GB), RTF "
              f"{total_ms / 1e3 / audio_s:.6f}; the vocoding alone "
              + ", ".join(f"{k} {ms:.3f} ms (peak {gb:.2f} GB)"
                          for k, (ms, gb) in modes.items())
              + f"; so the acoustic model {total_ms - voc_ms:.3f} ms, RTF "
              f"{(total_ms - voc_ms) / 1e3 / audio_s:.6f}")
    mel, mel_len = outputs[0]
    one = mel[0, :int(mel_len[0])].float()
    gl_ms, wav = wall_ms(
        lambda: griffin_lim_from_log_mel(one, n_iter=GL_ITERS), 3, warmup=3)
    check(wav.shape == ((one.shape[0] - 1) * 256,)
          and bool(torch.isfinite(wav).all()), "Griffin-Lim waveform")
    print(f"Griffin-Lim {GL_ITERS} iterations B=1, {one.shape[0]} frames: "
          f"{gl_ms:.3f} ms (median of 3), RTF "
          f"{gl_ms / 1e3 / ((one.shape[0] - 1) * HOP_SECONDS):.6f}")
    del model, vocoder
    torch.cuda.empty_cache()


def gan_batch(gen, b: int, segment: int) -> torch.Tensor:
    return waveforms(gen, b, segment / SAMPLE_RATE + 0.01)[:, :segment]


def mel_config(hp, generator):
    return dict(sample_rate=SAMPLE_RATE, n_fft=1024,
                hop_length=generator.hop_length, n_mels=hp.mel_dim)


def phase_vocoder_step(gen):
    """The vocoder GAN step at B=16 x hp.vocoder_segment_size, bf16 amp for
    G, with cuDNN's TF32 on as cli/train_vocoder.py runs it (torch's
    default): ms per step by CUDA events (median of 10 after 3),
    samples/s, peak memory; 20 steps on one batch with loss_mel falling;
    one fine-tuning step; then one fp32 step (TF32 off) on card and CPU
    from the same state."""
    from transformer_tts_tpu_torch.vocoder import trainer as vt
    hp = vocoder_hparams(amp=True)
    seg = hp.vocoder_segment_size
    audio = gan_batch(gen, GAN_BATCH, seg).to(DEVICE)
    state = vt.init_vocoder_state(hp, seg, device=DEVICE)
    step = vt.make_vocoder_train_step(hp, mel_config(hp, state.generator))
    with cudnn_tf32(True):
        for _ in range(3):
            step(state, audio)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logs = step(state, audio)
            end.record()
            losses.append(torch.stack(list(logs.values())))
            times.append((start, end))
        torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          "vocoder step: non-finite loss")
    print(f"vocoder GAN step B={GAN_BATCH} x {seg} samples, G bf16 amp, "
          f"cuDNN TF32: "
          f"{ms:.3f} ms/step (median of 10), "
          f"{GAN_BATCH * seg / ms * 1e3:.0f} samples/s, peak memory "
          f"{peak_gb:.2f} GB; last losses "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in logs.items()))
    PROFILES.append(partial(profile_vocoder_step, audio, ms, state, step))
    del state, step
    torch.cuda.empty_cache()

    state = vt.init_vocoder_state(hp, seg, device=DEVICE, seed=1)
    step = vt.make_vocoder_train_step(hp, mel_config(hp, state.generator))
    with cudnn_tf32(True):
        curve = torch.stack([step(state, audio)["loss_mel"]
                             for _ in range(20)]).cpu().tolist()
    print(f"vocoder: 20 steps on one batch: loss_mel {curve[0]:.4f} -> "
          f"{curve[-1]:.4f} ({[round(x, 3) for x in curve]})")
    check(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0],
          "vocoder: loss_mel did not fall over 20 steps")

    ft = vt.make_vocoder_train_step(hp, mel_config(hp, state.generator),
                                    predicted_mel_inputs=True)
    mel = torch.randn(GAN_BATCH, seg // state.generator.hop_length,
                      hp.mel_dim, generator=gen) - 4
    with cudnn_tf32(True):
        logs = ft(state, audio, mel.to(DEVICE))
    check(all(math.isfinite(float(v)) for v in logs.values()),
          "vocoder fine-tuning step: non-finite loss")
    print("vocoder fine-tuning step (predicted_mel_inputs) B="
          f"{GAN_BATCH}: " + ", ".join(f"{k} {float(v):.4f}"
                                      for k, v in logs.items()))
    del state, step, ft
    torch.cuda.empty_cache()
    phase_vocoder_card_vs_cpu(gen)


def phase_vocoder_card_vs_cpu(gen):
    """One fp32 GAN step (TF32 off) at B=2 on the card and on the CPU from
    the same state: the losses within 1e-4 relative, each of D's and G's
    gradients within GRAD_TOL of its own max|g|, each update within 1e-3
    lr of the CPU's where the two gradients bound it below that (Adam's
    first step, eps 1e-8, as phase 5a)."""
    from transformer_tts_tpu_torch.vocoder import trainer as vt
    hp = vocoder_hparams(amp=False)
    seg = hp.vocoder_segment_size
    audio = gan_batch(gen, GAN_CPU_BATCH, seg)
    ref = vt.init_vocoder_state(hp, seg, device="cpu")
    state = vt.init_vocoder_state(hp, seg, device=DEVICE)
    old = {}
    for role in ("generator", "discriminator"):
        weights = getattr(ref, role).state_dict()
        getattr(state, role).load_state_dict(weights)
        old[role] = {k: v.detach().clone()
                     for k, v in getattr(ref, role).named_parameters()}
    mel_cfg = mel_config(hp, state.generator)
    logs = vt.make_vocoder_train_step(hp, mel_cfg)(state, audio.to(DEVICE))
    ref_logs = vt.make_vocoder_train_step(hp, mel_cfg)(ref, audio)
    loss_rel = max(abs(float(logs[k]) - float(ref_logs[k]))
                   / max(abs(float(ref_logs[k])), 1e-30) for k in logs)
    lr = vt.vocoder_schedule(hp)(0)
    grad_rel, update_rel = {}, 0.0
    for role in ("generator", "discriminator"):
        cpu_params = dict(getattr(ref, role).named_parameters())
        for name, p in getattr(state, role).named_parameters():
            g, g_ref = p.grad.cpu(), cpu_params[name].grad
            err, peak = max_err(g, g_ref)
            grad_rel[f"{role}.{name}"] = err / peak if peak else float(err)
            step = p.detach().cpu() - old[role][name]
            ref_step = cpu_params[name].detach() - old[role][name]
            rounding = 2 * ulp(old[role][name].abs() + lr)
            least = (g_ref.abs() - err).clamp(min=0.0)
            settled = err * vt.ADAM_EPS / (least + vt.ADAM_EPS) ** 2 <= 1e-3
            if settled.any():
                update_rel = max(update_rel, ((step - ref_step).abs()
                                              - rounding)[settled].max()
                                 .item() / lr)
    worst = sorted(grad_rel, key=grad_rel.get)[-3:]
    print(f"vocoder GAN step B={GAN_CPU_BATCH} x {seg} card fp32 vs CPU "
          f"fp32: losses within {loss_rel:.3g} relative (tol 1e-4: "
          + ", ".join(f"{k} {float(logs[k]):.6f} vs {float(ref_logs[k]):.6f}"
                      for k in logs)
          + f"); {len(grad_rel)} gradients, each against its own max|g| "
          f"(tol {GRAD_TOL}): worst "
          + ", ".join(f"{n} {grad_rel[n]:.3g}" for n in worst)
          + f"; updates at lr {lr:.4g}: worst |d update| / lr "
          f"{update_rel:.3g} (tol 1e-3) where the gradients bound it")
    check(loss_rel <= 1e-4, "vocoder step: card losses disagree with CPU")
    check(max(grad_rel.values()) <= GRAD_TOL,
          f"vocoder step: card gradients disagree with CPU: {worst}")
    check(update_rel <= 1e-3, "vocoder step: card updates disagree")


def profile_vocoder_step(audio, ms_per_step, state, step):
    """``print_profile`` of one GAN step going on from the timed run's
    state."""
    with cudnn_tf32(True):
        print_profile("the vocoder GAN step", partial(step, state, audio),
                      1, ms_per_step)


def run_cli(module: str, *args) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", f"transformer_tts_tpu_torch.cli.{module}",
         *map(str, args)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    tail = proc.stdout.strip().splitlines()[-3:]
    print(f"cli.{module}: exit {proc.returncode}; " + " | ".join(tail))
    check(proc.returncode == 0, f"cli.{module} exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout


def prepare_vocoder_clis(gen) -> dict:
    """Phase 14's CLIs, which run with the other CLIs (``phase_clis``):
    WAVs written here; the first wave prepare_data on them, train_vocoder
    for 3 steps with a save and synthesize --wav on the transformer
    flagship's checkpoint of phase 4(c); the second synthesize --vocoder
    on it with the vocoder trained, all on the card."""
    from transformer_tts_tpu_torch.ops.features import write_wav
    work = os.path.join(WORK, "vocoder")
    os.makedirs(work, exist_ok=True)
    lines = []
    for i, seconds in enumerate(CLI_WAVS):
        path = os.path.join(work, f"utt{i}.wav")
        write_wav(path, waveforms(gen, 1, seconds)[0].numpy(), SAMPLE_RATE)
        lines.append(f"{path}|{i + 1} 7 9")
    wav_script = os.path.join(work, "wavs.txt")
    with open(wav_script, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    feats = os.path.join(work, "features")
    voc_dir = os.path.join(work, "train")
    hp_file = os.path.join(work, "hparams.py")
    with open(hp_file, "w") as fh:
        for key, value in dict(FLAGSHIP, save_dir=voc_dir).items():
            fh.write(f"{key} = {value!r}\n")
    model_dir = os.path.join(WORK, "transformer", "model")
    export = os.path.join(voc_dir, "generator")
    cli = "transformer_tts_tpu_torch.cli."
    first = {
        "prepare_data": [cli + "prepare_data", "--wav_script", wav_script,
                         "--out_dir", feats, "--device", DEVICE],
        "train_vocoder": [cli + "train_vocoder", "--hp_file", hp_file,
                          "--wav_script", wav_script, "--max_steps", "3",
                          "--save_every", "3", "--batch_size", "4",
                          "--device", DEVICE],
        "synthesize --wav": [cli + "synthesize", "--load_name", model_dir,
                             "--save", os.path.join(work, "griffin_lim"),
                             "--max_frames", "2048", "--device", DEVICE,
                             "--wav"]}
    second = {"synthesize --vocoder": [
        cli + "synthesize", "--load_name", model_dir, "--save",
        os.path.join(work, "vocoded"), "--max_frames", "2048", "--device",
        DEVICE, "--vocoder", export]}
    return dict(first=first, second=second, work=work, feats=feats,
                voc_dir=voc_dir, model_dir=model_dir)


def check_vocoder_clis(v: dict, outs: dict):
    """What phase 14's CLIs wrote: every feature file and WAV's shape and
    values, the vocoder's checkpoint and export. Then
    load_reference_checkpoint of a ``module.``-prefixed file of the
    flagship's checkpoint."""
    from transformer_tts_tpu_torch.compat.torch_import import (
        load_reference_checkpoint)
    from transformer_tts_tpu_torch.config import load_hparams
    from transformer_tts_tpu_torch.ops.features import read_wav
    work, feats, voc_dir = v["work"], v["feats"], v["voc_dir"]
    for name in (*v["first"], *v["second"]):
        print(f"cli.{name}: exit 0; "
              + " | ".join(outs[name].strip().splitlines()[-3:]))
    for i, seconds in enumerate(CLI_WAVS):
        frames = int(seconds * SAMPLE_RATE) // 256 + 1
        arrays = [np.load(os.path.join(feats, f"utt{i}{s}.npy"))
                  for s in ("", "_f0", "_energy")]
        check(arrays[0].shape == (frames, 80) and arrays[1].shape
              == arrays[2].shape == (frames,)
              and all(np.isfinite(a).all() for a in arrays),
              f"prepare_data: utterance {i}")
    for name in ("mean.npy", "var.npy", "lengths.npy", "train_script.txt",
                 "variance_stats.json"):
        check(os.path.exists(os.path.join(feats, name)),
              f"prepare_data wrote no {name}")
    check(os.path.exists(os.path.join(voc_dir, "generator", "generator.pt"))
          and os.path.exists(os.path.join(voc_dir, "vocoder_3",
                                          "train_state.pt")),
          "train_vocoder wrote no checkpoint or export")
    for flags, name, short in ((["--vocoder"], "vocoded", 0),
                               (["--wav"], "griffin_lim", 1)):
        out_dir = os.path.join(work, name)
        for i in range(3):
            n = np.load(os.path.join(out_dir, f"{i}.npy")).shape[0]
            audio, rate = read_wav(os.path.join(out_dir, f"{i}.wav"))
            check(rate == SAMPLE_RATE and audio.shape == ((n - short) * 256,)
                  and bool(np.isfinite(audio).all()),
                  f"synthesize {name}: wav {i} {audio.shape} for {n} frames")
        print(f"synthesize {' '.join(flags[:1])}: 3 WAVs of frames x 256"
              f"{' - 256' if short else ''} samples written and checked")

    model_dir = v["model_dir"]
    hp = load_hparams(os.path.join(model_dir, "hparams.py"))
    state = torch.load(os.path.join(model_dir, "model.pt"),
                       map_location="cpu", weights_only=True)
    path = os.path.join(work, "network.epoch1")
    torch.save({f"module.{k}": v for k, v in state.items()}, path)
    model = load_reference_checkpoint(path, hp, device=DEVICE)
    loaded = model.state_dict()
    check(list(loaded) == list(state) and all(
        torch.equal(loaded[k].cpu(), v) for k, v in state.items()),
        "load_reference_checkpoint: the weights differ")
    print(f"load_reference_checkpoint: {len(state)} tensors of a "
          f"module.-prefixed file loaded on the card bit for bit")


def phase_clis(sq: dict, vocoder: dict) -> dict:
    """Every CLI of the run at once: the training CLIs of 5, 6, 15, 16, 19
    and 22 with 16's SQ runs, 4(c)'s synthesis CLIs and the first waves
    of 14 and 22; then the synthesis CLIs on the trained checkpoints with
    the second waves of 14 and 22 and 16's averages; each checked but
    16's and 22's (their outputs: the return value, and
    ``POST_CLIS["outs"]``). Returns 16's output."""
    synth = {f"{name} synthesis CLI": c["argv"]
             for name, c in SYNTH_CLIS.items()}
    outs = phase_train_clis(
        dict(sq["runs"], **synth, **vocoder["first"], **POST_CLIS["first"]),
        dict(vocoder["second"], **sq["average"], **POST_CLIS["second"]))
    POST_CLIS["outs"] = {name: outs[name] for name in (
        *POST_CLIS.pop("first"), *POST_CLIS.pop("second"))}
    for name in list(SYNTH_CLIS):
        check_synth_cli(name, outs[f"{name} synthesis CLI"])
    check_vocoder_clis(vocoder, outs)
    return {name: outs[name] for name in (*sq["runs"], *sq["average"])}


# ---- phase 17: serving ------------------------------------------------------

SERVE_BUCKETS = (32, 64, 128)    # text buckets; mel budgets 256, 512, 1024
SERVE = dict(batch_size=8, frames_per_phone=8, text_buckets=SERVE_BUCKETS)
SERVE_REPS = 10
SERVE_LOAD = (64, 16, (20, 120))  # requests, client threads, phones
OVERLOAD = (32, 4)                # simultaneous requests, max_queue
STREAM_BUCKET = 64
STREAM_SEGMENT = 32               # AR decode steps per stream segment
SERVE_TOL = 1e-4                  # of max|ref|: fp32 serving against solo,
                                  # streamed against one-shot audio


def serving_dir(name: str, net=None, **overrides) -> str:
    """``WORK/serving/name`` with the port checkpoint of ``net`` (when
    given) and an ``hparams.py`` of FLAGSHIP with ``overrides``."""
    from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
    path = os.path.join(WORK, "serving", name)
    os.makedirs(path, exist_ok=True)
    if net is not None:
        save_checkpoint(net, path)
    with open(os.path.join(path, "hparams.py"), "w") as fh:
        for key, value in dict(FLAGSHIP, **overrides).items():
            fh.write(f"{key} = {value!r}\n")
    return path


def serve_texts(rs, n: int, lo: int, hi: int, vocab: int) -> list:
    """``n`` token-id lists, lengths uniform in [lo, hi], ids in [1,
    vocab)."""
    return [rs.randint(1, vocab, rs.randint(lo, hi + 1)).tolist()
            for _ in range(n)]


def engine_call_launches(engine, texts) -> tuple:
    """(results, launch counts) of one ``engine.synthesize`` call, every
    count set to 0 just before it and read just after."""
    set_counts({})
    results = engine.synthesize(texts)
    torch.cuda.synchronize()
    return results, read_counts()


def check_only(launches: dict, kid, n: int, what: str):
    check(launches.get(kid, 0) == n
          and all(v == 0 for k, v in launches.items() if k != kid),
          f"{what}: launches {json.dumps(launches)}, expected {n} of {kid} "
          "and none of the others")


def audio_rate(results, ms: float) -> float:
    """Seconds of audio (frames x 256/22050) per second of wall."""
    frames = sum(r["mel"].shape[0] for r in results)
    return frames * HOP_SECONDS / (ms / 1e3)


def phase_fastspeech2_engine(fs2_dir, texts_by_bucket) -> tuple:
    """17(a): the transformer flagship's engine (bf16 amp, batch 8):
    warmup per bucket; per bucket one call of 8 requests, 6 K1-90
    launches and no other kernel, its mel bit for bit
    synthesize_fastspeech2 on the same padded tensors; ms per call and
    audio-seconds per second."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    engine = TTSEngine(fs2_dir, **SERVE, device=DEVICE)
    for bucket, sec in engine.warmup().items():
        print(f"17(a) FastSpeech 2 engine warmup bucket {bucket} (max_frames "
              f"{engine.max_frames_for(bucket)}): {sec:.3f} s")
    per_call = []
    for bucket, texts in texts_by_bucket.items():
        results, launches = engine_call_launches(engine, texts)
        per_call.append(launches["K1-90"])
        check_only(launches, "K1-90", engine.hp.n_layer_decoder,
                   f"17(a) bucket {bucket}")
        order = sorted(range(len(texts)), key=lambda i: len(texts[i]))
        text, pos = engine._padded([texts[i] for i in order], len(texts),
                                   bucket)
        mel, mel_len, dur = synthesize_fastspeech2(
            engine.model, text, pos, engine.max_frames_for(bucket),
            engine._mean, engine._var)
        mel, mel_len = mel.float().cpu().numpy(), mel_len.cpu().numpy()
        dur = dur.cpu().numpy()
        for row, i in enumerate(order):
            n = int(mel_len[row])
            check(np.array_equal(results[i]["mel"], mel[row, :n])
                  and np.array_equal(results[i]["durations"],
                                     dur[row, :len(texts[i])]),
                  f"17(a) bucket {bucket}: request {i} differs from "
                  "synthesize_fastspeech2 on the same padded tensors")
        ms, _ = wall_ms(lambda: engine.synthesize(texts), SERVE_REPS,
                        warmup=2)
        frames = [r["mel"].shape[0] for r in results]
        print(f"17(a) FastSpeech 2 engine bucket {bucket}, 8 requests of "
              f"{min(len(t) for t in texts)}-{max(len(t) for t in texts)} "
              f"phones, {sum(frames)} frames: {ms:.3f} ms/call (median of "
              f"{SERVE_REPS}, host clock, results on the host), "
              f"{audio_rate(results, ms):.1f} audio-s/s; launches "
              f"{launches['K1-90']} K1-90, none other; mel bit for bit "
              "synthesize_fastspeech2")
    return engine, per_call


def post_json(port: int, path: str, body=None, method="POST") -> tuple:
    from http.client import HTTPConnection
    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def load_run(engine, texts, threads: int, **server_kw) -> dict:
    """``texts`` as single /synthesize requests from ``threads`` client
    threads (each sends its share in turn) to a TTSServer on ``engine``:
    statuses, responses, client latencies (ms), wall seconds, /metrics."""
    import threading
    from transformer_tts_tpu_torch.infer.server import TTSServer
    server = TTSServer(engine, host="127.0.0.1", port=0, **server_kw)
    server.start()
    out = {"status": [None] * len(texts), "body": [None] * len(texts),
           "ms": [None] * len(texts)}

    def client(k):
        for i in range(k, len(texts), threads):
            t0 = time.perf_counter()
            status, body = post_json(server.port, "/synthesize",
                                     {"text_ids": texts[i]})
            out["ms"][i] = (time.perf_counter() - t0) * 1e3
            out["status"][i], out["body"][i] = status, body

    workers = [threading.Thread(target=client, args=(k,))
               for k in range(threads)]
    try:
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        out["wall_s"] = time.perf_counter() - t0
        check(not any(w.is_alive() for w in workers), "a client hung")
        out["metrics"] = json.loads(post_json(server.port, "/metrics",
                                              method="GET")[1])
    finally:
        server.stop()
    return out


def print_load(label: str, run: dict):
    ms = np.asarray(run["ms"])
    print(f"17(b) {label}: {len(ms)} requests from {SERVE_LOAD[1]} threads, "
          f"batch_window_ms 5: latency p50 {np.percentile(ms, 50):.1f} ms, "
          f"p95 {np.percentile(ms, 95):.1f}, max {ms.max():.1f}; "
          f"{len(ms) / run['wall_s']:.2f} requests/s; /metrics "
          f"{json.dumps(run['metrics'])}")


def solo_at(engine, text, bucket: int) -> tuple:
    """(mel, durations) of ``text`` alone, padded as the engine pads a
    batch (``batch_size`` rows) to ``bucket``."""
    with engine.lock:
        mel, mel_len, dur = engine._run_padded(
            *engine._padded([text], engine.batch_size, bucket))
        n = int(mel_len[0])
        return (mel[0, :n].float().cpu().numpy(),
                dur[0, :len(text)].cpu().numpy())


def phase_server_load(engine, fs2_dir, fp32_hp):
    """17(b): the load of SERVE_LOAD through TTSServer, first on an fp32
    engine (each response against its text's solo call at the bucket its
    batch used), then on the bf16 engine of (a) (the numbers); then
    overload."""
    import threading
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.server import (
        TTSServer, _result_to_json)
    n, threads, (lo, hi) = SERVE_LOAD
    texts = serve_texts(np.random.RandomState(0), n, lo, hi,
                        engine.hp.vocab_size)
    check(len({tuple(t) for t in texts}) == n, "17(b) repeated texts")
    fp32 = TTSEngine(fs2_dir, fp32_hp, **SERVE, device=DEVICE)
    fp32.warmup()
    # the bucket each text's batch was padded to, as the engine reports it
    served, synthesize = {}, fp32.synthesize

    def recording(batch, speakers=None):
        results = synthesize(batch, speakers)
        served.update((tuple(t), r["bucket"]) for t, r in zip(batch, results))
        return results

    fp32.synthesize = recording
    run = load_run(fp32, texts, threads, batch_window_ms=5.0)
    check(run["status"] == [200] * n, f"17(b) fp32 statuses {run['status']}")
    worst, own = 0.0, 0
    for text, body in zip(texts, run["body"]):
        resp = json.loads(body)
        # a batch pads to the bucket of its longest text, and the model's
        # SAME-padded convolutions read the padding: the reference is the
        # solo call at the bucket that served the text
        bucket = served[tuple(text)]
        own += bucket == fp32._bucket_of(len(text))
        mel, dur = solo_at(fp32, text, bucket)
        check(resp["mel_frames"] == mel.shape[0]
              and resp["durations"] == dur.tolist(),
              f"17(b) a served response ({len(text)} phones, bucket "
              f"{bucket}, {resp['mel_frames']} frames) differs from its solo "
              f"call's durations or length ({mel.shape[0]} frames)")
        got = np.asarray(resp["mel"], np.float32).reshape(mel.shape)
        worst = max(worst, float(np.abs(got - mel).max(initial=0.0)
                                 / max(np.abs(mel).max(initial=0.0), 1e-30)))
    check(worst <= SERVE_TOL, f"17(b) served mel off its solo call by "
                              f"{worst:.3g} of max|ref|")
    print_load("fp32 engine (amp off, TF32 off)", run)
    print(f"17(b) fp32: every response's durations and mel_frames equal its "
          f"text's solo call at the bucket the engine reports for it, "
          f"{own} of {n} at the text's own bucket and the rest at the larger "
          f"bucket of the batch that served it; mel "
          f"within {worst:.3g} of max|ref| (limit {SERVE_TOL})")
    del fp32
    run = load_run(engine, texts, threads, batch_window_ms=5.0)
    check(run["status"] == [200] * n, f"17(b) bf16 statuses {run['status']}")
    print_load("bf16 engine of (a)", run)
    results = engine.synthesize(texts[:8])
    ms, _ = wall_ms(lambda: [json.dumps(_result_to_json(r))
                             for r in results], 3)
    print(f"17(b) the responses' JSON on the host: {ms / 8:.2f} ms per "
          f"response ({np.mean([r['mel'].shape[0] for r in results]):.0f} "
          "frames of 80 floats on average; median of 3, one thread)")

    count, max_queue = OVERLOAD
    server = TTSServer(engine, host="127.0.0.1", port=0,
                       batch_window_ms=5.0, max_queue=max_queue)
    server.start()
    statuses, barrier = [], threading.Barrier(count)
    long_text = serve_texts(np.random.RandomState(1), 1, hi, hi,
                            engine.hp.vocab_size)[0]

    def client():
        barrier.wait()
        statuses.append(post_json(server.port, "/synthesize",
                                  {"text_ids": long_text})[0])

    workers = [threading.Thread(target=client) for _ in range(count)]
    try:
        # the engine busy, as behind a long request: the batcher holds at
        # most one batch, the queue max_queue, and the rest must get 503
        with engine.lock:
            for w in workers:
                w.start()
            deadline = time.perf_counter() + 120
            while (len(statuses) < count - max_queue - SERVE["batch_size"]
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
        for w in workers:
            w.join(timeout=600)
    finally:
        server.stop()
    check(len(statuses) == count and set(statuses) <= {200, 503}
          and 503 in statuses and 200 in statuses,
          f"17(b) overload statuses {statuses}")
    print(f"17(b) overload, max_queue {max_queue}, {count} simultaneous "
          f"requests while the engine is busy: {statuses.count(200)} x 200, "
          f"{statuses.count(503)} x 503, no other status")


def stream_timed(engine, text, **kw) -> tuple:
    """(events, ms to the first audio event, ms to the end) of one
    stream."""
    t0 = time.perf_counter()
    events, first = [], None
    for ev in engine.synthesize_streaming(text, **kw):
        if first is None and ev["type"] == "audio":
            first = (time.perf_counter() - t0) * 1e3
        events.append(ev)
    return events, first, (time.perf_counter() - t0) * 1e3


def pcm_error(events, ref: dict, what: str) -> float:
    """max|streamed pcm - one-shot audio| over max|audio|, checked."""
    check(events[-1]["type"] == "end"
          and events[-1]["mel_frames"] == ref["mel"].shape[0],
          f"{what}: end {events[-1]}, one-shot {ref['mel'].shape[0]} frames")
    pcm = np.concatenate([e["pcm"] for e in events if e["type"] == "audio"])
    check(pcm.shape == ref["audio"].shape, f"{what}: {pcm.shape} samples, "
                                           f"one-shot {ref['audio'].shape}")
    err = float(np.abs(pcm - ref["audio"]).max()
                / max(float(np.abs(ref["audio"]).max()), 1e-30))
    check(err <= SERVE_TOL, f"{what}: streamed pcm off the one-shot audio by "
                            f"{err:.3g} of max|audio|")
    return err


def phase_streaming(fs2_dir, fp32_hp, ar_dir, ar_fp32_hp, voc_dir):
    """17(c): streams with HiFi-GAN V1 (fp32, TF32 off) on fp32 engines of
    batch 1 at bucket STREAM_BUCKET: FastSpeech 2, then the AR model
    (segments of STREAM_SEGMENT steps): time to first audio and total,
    the pcm against the one-shot audio; two AR streams advanced in turn
    with a server batch request between their segments; an AR stream
    whose decode stops inside a segment."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.server import TTSServer
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_transformer_tts)
    rs = np.random.RandomState(2)
    kw = dict(batch_size=1, text_buckets=(STREAM_BUCKET,), vocoder=voc_dir,
              device=DEVICE)
    nar = TTSEngine(fs2_dir, fp32_hp, **kw)
    nar.warmup(streaming=True)
    text = serve_texts(rs, 1, STREAM_BUCKET - 14, STREAM_BUCKET - 14,
                       nar.hp.vocab_size)[0]
    ref = nar.synthesize([text])[0]
    events, ttfa, total = stream_timed(nar, text)
    err = pcm_error(events, ref, "17(c) FastSpeech 2 stream")
    print(f"17(c) FastSpeech 2 stream, {len(text)} phones, "
          f"{ref['mel'].shape[0]} frames: first audio {ttfa:.1f} ms, total "
          f"{total:.1f} ms, {len(events) - 1} chunks; pcm within {err:.3g} "
          f"of max|audio| of the one-shot audio (limit {SERVE_TOL})")
    del nar

    ar = TTSEngine(ar_dir, ar_fp32_hp, **kw)
    ar.warmup(streaming=True)
    texts = serve_texts(rs, 3, STREAM_BUCKET - 20, STREAM_BUCKET - 4,
                        ar.hp.vocab_size)
    refs = ar.synthesize(texts[:2])
    events, ttfa, total = stream_timed(ar, texts[0],
                                       segment_steps=STREAM_SEGMENT)
    err = pcm_error(events, refs[0], "17(c) AR stream")
    print(f"17(c) AR stream, {len(texts[0])} phones, "
          f"{refs[0]['mel'].shape[0]} frames (no stop: the budget), "
          f"segments of {STREAM_SEGMENT} steps: first audio {ttfa:.1f} ms, "
          f"total {total:.1f} ms, {len(events) - 1} chunks; pcm within "
          f"{err:.3g} of max|audio|")

    server = TTSServer(ar, host="127.0.0.1", port=0)
    server.start()
    streams = [iter(ar.synthesize_streaming(t, segment_steps=STREAM_SEGMENT))
               for t in texts[:2]]
    got, done, batches = [[], []], [False, False], 0
    try:
        while not all(done):
            for i in (0, 1):
                if done[i]:
                    continue
                ev = next(streams[i], None)
                if ev is None:
                    done[i] = True
                    continue
                got[i].append(ev)
                if i == 1 and len(got[1]) % 2 == 1:
                    status, body = post_json(server.port, "/synthesize",
                                             {"batch": texts[2:]})
                    check(status == 200, f"17(c) server batch {status}")
                    batches += 1
    finally:
        server.stop()
    errs = [pcm_error(got[i], refs[i], f"17(c) interleaved AR stream {i}")
            for i in (0, 1)]
    print(f"17(c) two AR streams at bucket {STREAM_BUCKET} advanced in turn, "
          f"{batches} server batch requests at the same graph key between "
          f"their segments: each equals its one-shot audio within "
          f"{max(errs):.3g} of max|audio|")

    # a decode that stops inside a segment: the graph blocks overrun it
    model, max_steps = ar.model, ar.max_frames_for(STREAM_BUCKET) // 2
    store = []
    with ar.lock:
        t, p = ar._padded([texts[0]], 1, STREAM_BUCKET)
        with stop_logits(model, store):
            synthesize_transformer_tts(model, t, p, max_steps=max_steps,
                                       eager=True)
        bias = stopping_bias(store[0], max_steps)
        with torch.no_grad():
            model.stop_token.bias.fill_(bias)
    ref = ar.synthesize([texts[0]])[0]
    events, ttfa, total = stream_timed(ar, texts[0],
                                       segment_steps=STREAM_SEGMENT)
    err = pcm_error(events, ref, "17(c) stopping AR stream")
    n = ref["mel"].shape[0]
    check(n < 2 * max_steps, "17(c) the stop bias did not stop the decode")
    print(f"17(c) AR stream stopping at {n} frames ({n // 2} steps; segment "
          f"{n // 2 // STREAM_SEGMENT + 1} runs to step "
          f"{min(max_steps, -(-(n // 2) // 8) * 8)}): end mel_frames = "
          f"one-shot {n}, pcm within {err:.3g} of max|audio|, first audio "
          f"{ttfa:.1f} ms, total {total:.1f} ms")


def weight_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def call_peak(engine, texts) -> tuple:
    """(results, peak card bytes of one call over what was allocated
    before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    results = engine.synthesize(texts)
    torch.cuda.synchronize()
    return results, torch.cuda.max_memory_allocated() - base


def fixed_variance_errors(engine, others: dict, texts, bucket: int) -> dict:
    """{name: {"d": (max|dmel| / max|mel|, mean|dmel| / mean|mel|) with the
    durations fixed, "dpe": the same with the pitch and energy fixed too,
    "flips": the share of valid frames whose pitch or energy bin moves}}
    of each of ``others``' models against ``engine``'s, on the same padded
    batch, over the valid frames. The fixed values are the engine's own
    predictions, so a rounded duration or a bin that another model moves
    does not change what the embeddings add: "dpe" reads the weights'
    error alone."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    text, pos = engine._padded(texts, len(texts), bucket)
    max_frames = engine.max_frames_for(bucket)
    _, mel_len, dur = synthesize_fastspeech2(engine.model, text, pos,
                                             max_frames)
    valid = (torch.arange(max_frames, device=mel_len.device)[None]
             < mel_len[:, None])

    def run(model, **targets):
        """(mel on valid frames, raw pitch, raw energy, their bins)."""
        va = model.variance_adaptor
        with torch.inference_mode():
            out = model(text, pad_mask(pos), max_frames, d_target=dur,
                        **targets)
        p = va._destandardize(out.pitch, va.f0_stats).float()
        e = va._destandardize(out.energy, va.energy_stats).float()
        bins = (torch.bucketize(p, va.pitch_bins),
                torch.bucketize(e, va.energy_bins))
        return (torch.where(valid[:, :, None], out.mel_post.float(), 0.0),
                p, e, bins)

    def errors(mel, ref):
        diff = (mel - ref).abs()
        return (float(diff.max() / ref.abs().max()),
                float(diff.sum() / ref.abs().sum()))

    ref, p, e, ref_bins = run(engine.model)
    fixed = dict(p_target=p, e_target=e)
    ref_fixed = run(engine.model, **fixed)[0]
    out = {}
    for name, model in others.items():
        mel, _, _, bins = run(model)
        moved = ((bins[0] != ref_bins[0]) | (bins[1] != ref_bins[1])) & valid
        out[name] = {"d": errors(mel, ref),
                     "dpe": errors(run(model, **fixed)[0], ref_fixed),
                     "flips": float(moved.sum() / valid.sum())}
    return out


def phase_int8(engine, fs2_dir, fp32_hp, ar_dir, texts_by_bucket):
    """17(d): the FastSpeech 2 engine with int8 weights against (a)'s:
    max|dmel| / max|mel| over common frames, ms per call, weight bytes,
    each call's peak; one AR int8 call, its graph's bf16 weight copies
    the dequantized weights."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.synthesize import _AR_GRAPHS
    q8 = TTSEngine(fs2_dir, **SERVE, quantize="int8", device=DEVICE)
    q8.warmup()
    fp32 = TTSEngine(fs2_dir, fp32_hp, **SERVE, device=DEVICE)
    s = q8.quantize_stats
    print(f"17(d) int8 quantization: {s['n_quantized']} tensors quantized, "
          f"{s['n_passthrough']} passed through; {s['bytes_fp']} bytes -> "
          f"{s['bytes_q']} as int8 + scales ({s['compression']:.3f}x); card "
          f"weight bytes (parameters and buffers) fp {weight_bytes(engine.model)}"
          f", int8 engine {weight_bytes(q8.model)}: the parameters hold q * s "
          "in fp32")
    for bucket, texts in texts_by_bucket.items():
        ref, ref_peak = call_peak(engine, texts)
        got, q8_peak = call_peak(q8, texts)
        changed = sum(not np.array_equal(a["durations"], b["durations"])
                      for a, b in zip(ref, got))
        check(all(np.isfinite(b["mel"]).all() for b in got),
              "17(d) non-finite int8 mel")
        errs = fixed_variance_errors(engine, {"int8": q8.model,
                                              "fp32": fp32.model},
                                     texts, bucket)
        ms, _ = wall_ms(lambda: engine.synthesize(texts), SERVE_REPS,
                        warmup=1)
        q8_ms, _ = wall_ms(lambda: q8.synthesize(texts), SERVE_REPS,
                           warmup=1)
        print(f"17(d) bucket {bucket}: max|dmel| / max|mel| and "
              f"mean|dmel| / mean|mel| against the bf16 engine, at its "
              f"durations: int8 {errs['int8']['d'][0]:.4g}, "
              f"{errs['int8']['d'][1]:.4g}, fp32 (the precision's own) "
              f"{errs['fp32']['d'][0]:.4g}, {errs['fp32']['d'][1]:.4g}; "
              f"at its durations, pitch and energy: int8 "
              f"{errs['int8']['dpe'][0]:.4g}, {errs['int8']['dpe'][1]:.4g}, "
              f"fp32 {errs['fp32']['dpe'][0]:.4g}, "
              f"{errs['fp32']['dpe'][1]:.4g}; frames with a pitch or energy "
              f"bin moved at its durations: int8 "
              f"{errs['int8']['flips']:.4g}, fp32 "
              f"{errs['fp32']['flips']:.4g}; "
              f"free-running, {changed} of {len(texts)} requests with a "
              f"changed duration; ms/call bf16 {ms:.3f}, int8 {q8_ms:.3f}; "
              f"call peak over what was allocated before: bf16 {ref_peak} "
              f"bytes, int8 {q8_peak}")
    del q8, fp32

    ar_q8 = TTSEngine(ar_dir, batch_size=8, frames_per_phone=8,
                      text_buckets=(STREAM_BUCKET,), quantize="int8",
                      device=DEVICE)
    texts = serve_texts(np.random.RandomState(3), 8, STREAM_BUCKET // 2 + 1,
                        STREAM_BUCKET, ar_q8.hp.vocab_size)
    ms, results = wall_ms(lambda: ar_q8.synthesize(texts), 1)
    check(all(np.isfinite(r["mel"]).all() and r["mel"].shape[0] > 0
              for r in results), "17(d) AR int8 output")
    copies = [(mod, name, copy) for graph in _AR_GRAPHS[ar_q8.model].values()
              for mod, name, copy in graph.weights.slots]
    check(copies and all(torch.equal(
        copy, mod._parameters[name].to(torch.bfloat16))
        for mod, name, copy in copies),
        "17(d) the AR graph reads other weights than the dequantized ones")
    print(f"17(d) AR int8 engine, one call of 8 at bucket {STREAM_BUCKET}: "
          f"{ms:.1f} ms, {sum(r['mel'].shape[0] for r in results)} frames; "
          f"its graph reads {len(copies)} bf16 copies, each equal to its "
          f"dequantized parameter ({ar_q8.quantize_stats['n_quantized']} "
          "tensors int8)")


def phase_other_engines(conf_dir, gst_dir, ref_path, ar_dir) -> dict:
    """17(e): one conformer engine call (6 K4-90), one GST call with
    ref_mel and the refusal without it, the AR engine's warmup with graph
    capture per bucket and one batch call (no kernel)."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    rs = np.random.RandomState(4)
    launches = {}
    conf = TTSEngine(conf_dir, **SERVE, device=DEVICE)
    texts = serve_texts(rs, 8, STREAM_BUCKET // 2 + 1, STREAM_BUCKET,
                        conf.hp.vocab_size)
    t0 = time.perf_counter()
    results, counts = engine_call_launches(conf, texts)
    ms = (time.perf_counter() - t0) * 1e3
    check_only(counts, "K4-90", conf.hp.n_layer_decoder, "17(e) conformer")
    launches["conformer engine call"] = counts["K4-90"]
    print(f"17(e) conformer engine, one first call of 8 at bucket "
          f"{STREAM_BUCKET}: {ms:.1f} ms, "
          f"{sum(r['mel'].shape[0] for r in results)} frames, launches "
          f"{counts['K4-90']} K4-90 and none other")
    del conf

    try:
        TTSEngine(gst_dir, **SERVE, device=DEVICE)
        fail("17(e) a GST engine without ref_mel was not refused")
    except ValueError as e:
        check("ref_mel" in str(e), f"17(e) GST refusal: {e}")
    gst = TTSEngine(gst_dir, **SERVE, ref_mel=ref_path, device=DEVICE)
    ms, results = wall_ms(lambda: gst.synthesize(texts), 1)
    check(all(np.isfinite(r["mel"]).all() and r["mel"].shape[0] > 0
              for r in results), "17(e) GST output")
    print(f"17(e) GST engine with a reference mel, one first call of 8 at "
          f"bucket {STREAM_BUCKET}: {ms:.1f} ms, lengths "
          f"{[r['mel'].shape[0] for r in results]} (no stop); refused "
          "without ref_mel")
    del gst

    ar = TTSEngine(ar_dir, **SERVE, device=DEVICE)
    for bucket, sec in ar.warmup().items():
        print(f"17(e) AR engine warmup bucket {bucket} (graph capture, "
              f"{ar.max_frames_for(bucket) // 2} steps): {sec:.3f} s")
    texts = serve_texts(rs, 8, SERVE_BUCKETS[-1] // 2 + 1, SERVE_BUCKETS[-1],
                        ar.hp.vocab_size)
    ms, (results, counts) = wall_ms(lambda: engine_call_launches(ar, texts), 3)
    check(all(v == 0 for v in counts.values()),
          f"17(e) the AR engine call launched {json.dumps(counts)}")
    steps = ar.max_frames_for(SERVE_BUCKETS[-1]) // 2
    check(all(r["mel"].shape[0] == 2 * steps for r in results),
          "17(e) an AR row stopped at AR_STOP_BIAS")
    print(f"17(e) AR engine batch call, 8 requests at bucket "
          f"{SERVE_BUCKETS[-1]}, {steps} steps (no stop): {ms:.2f} ms "
          f"(median of 3) = {ms / steps:.4f} ms/step, no kernel launched")
    return launches


def start_serve_cli(fs2_dir):
    """17(f)'s cli/serve.py --port 0 as a subprocess, started when the
    checkpoint is written so that it warms up while 17(a)-(e) run."""
    return subprocess.Popen(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.serve",
         "--load_name", fs2_dir, "--port", "0", "--buckets", "32,64",
         "--device", DEVICE], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def phase_serve_cli(proc):
    """17(f): ``start_serve_cli``'s server: a POST, /metrics, a wav
    request on Griffin-Lim, then SIGINT and exit 0 within 10 s."""
    import base64
    import io
    import signal
    import wave
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving on"):
                break
        check(lines and lines[-1].startswith("serving on"),
              "17(f) serve CLI: " + " | ".join(lines[-20:]))
        port = int(lines[-1].split()[2].rsplit(":", 1)[1])
        text = serve_texts(np.random.RandomState(5), 1, 40, 40, 152)[0]
        status, body = post_json(port, "/synthesize", {"text_ids": text})
        resp = json.loads(body)
        check(status == 200 and resp["mel_frames"] == len(resp["mel"]) > 0,
              f"17(f) POST {status}")
        status, wav_body = post_json(port, "/synthesize",
                                     {"text_ids": text, "wav": True})
        wav_resp = json.loads(wav_body)
        with wave.open(io.BytesIO(base64.b64decode(
                wav_resp["wav_base64"]))) as fh:
            samples = fh.getnframes()
        check(status == 200 and samples == (wav_resp["mel_frames"] - 1) * 256,
              f"17(f) Griffin-Lim wav {status}, {samples} samples")
        status, body = post_json(port, "/metrics", method="GET")
        metrics = json.loads(body)
        check(status == 200 and metrics["requests"] == 2,
              f"17(f) /metrics {status} {metrics}")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=10)
        check(rc == 0, f"17(f) serve CLI exit {rc} after SIGINT")
        print(f"17(f) cli/serve.py: {' | '.join(lines)}; POST "
              f"{resp['mel_frames']} frames in {resp['ms']} ms; Griffin-Lim "
              f"wav {samples} samples in {wav_resp['ms']} ms; /metrics "
              f"{json.dumps(metrics)}; SIGINT -> exit 0 in "
              f"{time.perf_counter() - t0:.2f} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def phase_serving(gen, smi: str) -> dict:
    """Phase 17: the serving layer at the flagships' full width, random
    weights from seed 0; returns the engine calls' launch counts."""
    from transformer_tts_tpu_torch.vocoder.trainer import (
        GENERATOR_NAME, build_vocoder)
    print(smi)
    fp32 = dict(amp=False)
    _, model = flagship_model(DEVICE, amp=True, stacks={})
    fs2_dir = serving_dir("fastspeech2", model)
    serve_cli = start_serve_cli(fs2_dir)
    fp32_hp = os.path.join(serving_dir("fastspeech2_fp32", **fp32),
                           "hparams.py")
    _, model = flagship_model(DEVICE, amp=True, stacks=PATHS["conformer"][0])
    conf_dir = serving_dir("conformer", model, **PATHS["conformer"][0])
    _, model = ar_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    ar_dir = serving_dir("ar", model, model="Transformer")
    ar_fp32_hp = os.path.join(serving_dir("ar_fp32", model="Transformer",
                                          **fp32), "hparams.py")
    _, model = gst_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    gst_dir = serving_dir("gst", model, model="Transformer", gst=True)
    ref_path = os.path.join(gst_dir, "ref_mel.npy")
    np.save(ref_path, torch.randn(GST_REF_FRAMES[0], model.mel_dim,
                                  generator=gen).numpy())
    voc = build_vocoder(vocoder_hparams(), amp=False, device=DEVICE)
    voc_dir = os.path.join(WORK, "serving", "vocoder")
    os.makedirs(voc_dir, exist_ok=True)
    torch.save({k: v.cpu() for k, v in voc.state_dict().items()},
               os.path.join(voc_dir, GENERATOR_NAME))
    del model, voc
    torch.cuda.empty_cache()

    rs = np.random.RandomState(17)
    texts_by_bucket = {b: serve_texts(rs, 8, b // 2 + 1, b, 152)
                       for b in SERVE_BUCKETS}
    try:
        engine, per_call = phase_fastspeech2_engine(fs2_dir,
                                                    texts_by_bucket)
        launches = {"fastspeech2 engine calls (K1-90 each)": per_call}
        phase_server_load(engine, fs2_dir, fp32_hp)
        phase_streaming(fs2_dir, fp32_hp, ar_dir, ar_fp32_hp, voc_dir)
        phase_int8(engine, fs2_dir, fp32_hp, ar_dir, texts_by_bucket)
        del engine
        launches.update(phase_other_engines(conf_dir, gst_dir, ref_path,
                                            ar_dir))
        phase_serve_cli(serve_cli)
    finally:
        if serve_cli.poll() is None:
            serve_cli.kill()
            serve_cli.wait()
    return launches


# ---- phase 18: speaker, accent and hop-size conditioning --------------------

# the reference's speaker table (transformer_tts_tpu/models/encoder.py:196)
N_SPEAKERS = 247
XVECTOR_COND = dict(is_multi_speaker=True, spk_emb_type="x_vector",
                    spk_emb_dim=512,
                    spk_emb_architecture="encoder,middle,decoder",
                    use_hop=True, CTC_training=True, use_ssim=True)
SPKCONF_COND = dict(PATHS["conformer"][0], is_multi_speaker=True,
                    spk_emb_type="speaker_id", spk_emb_dim=N_SPEAKERS,
                    spk_emb_architecture="encoder,decoder", accent_emb=True,
                    use_pos=True, use_rnn_length=True)
AR_SPK_COND = dict(is_multi_speaker=True, spk_emb_type="speaker_id",
                   spk_emb_dim=N_SPEAKERS,
                   spk_emb_architecture="encoder,decoder", spk_emb_vers=1)
AR_XVEC_V2 = dict(is_multi_speaker=True, spk_emb_type="x_vector",
                  spk_emb_dim=512, spk_emb_vers=2)
AR_SPK_STEPS = 200                # decode groups of the speaker AR calls
ROW_TOL = 1e-6                    # of max|ref|: a batch row against its
                                  # solo call at the batch's shape


def conditioned(gen, hp, batch: dict) -> dict:
    """``batch`` with the conditioning ``hp`` asks for, drawn from
    ``gen``: x-vectors N(0, 1) or speaker ids, per-phone accents (0 on
    padding) and hop-size classes."""
    b, length = batch["text"].shape
    device = batch["text"].device
    out = dict(batch)
    if hp.is_multi_speaker:
        out["spk_emb"] = (torch.randn(b, 512, generator=gen)
                          if hp.spk_emb_dim == 512 else
                          torch.randint(0, hp.spk_emb_dim, (b,),
                                        generator=gen)).to(device)
    if hp.accent_emb:
        n = 13 if hp.encoder_type == "conformer" else 5
        acc = torch.randint(0, n, (b, length), generator=gen)
        out["accent"] = (acc * (batch["text"].cpu() != 0)).to(device)
    if hp.use_hop:
        out["hop_size"] = torch.randint(0, 3, (b,), generator=gen).to(device)
    return out


def no_pos_dropout(model):
    """The adaptor's positional encoding (a fixed dropout of 0.1, not an
    hparam) at 0, for the card-vs-CPU step."""
    model.variance_adaptor.pos.dropout.p = 0.0


def speaker_rows(gen, hp, b: int) -> torch.Tensor:
    return (torch.randn(b, 512, generator=gen) if hp.spk_emb_dim == 512
            else torch.randperm(hp.spk_emb_dim, generator=gen)[:b])


def phase_conditioned_training(gen, smi: str) -> tuple:
    """18(a), training: the x-vector flagship (encoder, middle, decoder,
    hop, CTC, SSIM) card fp32 against CPU fp32; then its bf16 step and
    the plain flagship's on one batch at TRAIN_BATCH, 10 timed steps each
    in turn, twice (plain, x-vector, plain, x-vector), both states kept
    for their profiles; CTC (16 x 1024 frames, 152 classes) and the
    conformer's LSTM (16 x 1024 x 384) forward+backward alone. Returns
    the x-vector steps' launches and the plain batch."""
    from transformer_tts_tpu_torch.models.variance_adaptor import UniLSTM
    from transformer_tts_tpu_torch.train.losses import ctc_aux_loss
    print(smi)
    phase_card_vs_cpu(gen, "xvector")
    b, text_len, mel_len, frames = TRAIN_BATCH
    batch = train_batch(gen, train_hparams(), b, text_len, mel_len, frames,
                        DEVICE)
    cond = conditioned(gen, trainer("xvector")["hparams"](), batch)
    runs, timed = {}, {"fastspeech2": [], "xvector": []}
    for kind, kind_batch in (("fastspeech2", batch), ("xvector", cond)) * 2:
        if kind not in runs:
            runs[kind] = train_run(kind, kind_batch)
        timed[kind].append(time_train_steps(runs[kind]))
    ms = {kind: statistics.median(x for r in rs for x in r["step_ms"])
          for kind, rs in timed.items()}
    own = {kind: max(r["own_gb"] for r in rs) for kind, rs in timed.items()}
    frames = int((batch["pos_mel"] > 0).sum())
    for kind, rs in timed.items():
        medians = ", ".join(f"{r['ms']:.3f}" for r in rs)
        print(f"18(a) {kind} train step B={b} L={text_len} T={mel_len} bf16 "
              f"amp dropout 0.1: {ms[kind]:.3f} ms/step (median of 2 x 10 "
              f"in turn; each run's median {medians}), "
              f"{frames / ms[kind] * 1e3:.0f} valid frames/s, the step's own "
              f"peak memory {own[kind]:.3f} GB; last "
              f"losses {json.dumps(rs[-1]['terms'])}; launches per step "
              f"{json.dumps(rs[0]['per_step'][0])}")
    print(f"18(a) conditioning costs {ms['xvector'] - ms['fastspeech2']:.3f} "
          f"ms/step ({ms['xvector'] / ms['fastspeech2'] - 1:+.1%}) and "
          f"{own['xvector'] - own['fastspeech2']:.3f} GB; {smi}")
    for kind, run in runs.items():
        PROFILES.append(partial(profile_train_step, run, ms[kind]))
    del runs, run
    torch.cuda.empty_cache()

    logits = torch.randn(b, mel_len, 152, device=DEVICE, requires_grad=True)
    mel_frames = (batch["pos_mel"] > 0).sum(1)
    labels = batch["text"]
    label_len = (labels != 0).sum(1)

    def ctc_step():
        logits.grad = None
        ctc_aux_loss(logits, mel_frames, labels, label_len).backward()
    ctc_ms = time_ms(ctc_step, reps=10)
    lstm = UniLSTM(384, 384).to(DEVICE)
    x = torch.randn(b, mel_len, 384, device=DEVICE, requires_grad=True)

    def lstm_step():
        lstm.zero_grad(set_to_none=True)
        lstm(x).sum().backward()
    lstm_ms = time_ms(lstm_step, reps=5)
    print(f"18(a) CTC loss over ({b}, {mel_len}, 152) logits, forward and "
          f"backward: {ctc_ms:.3f} ms (F.ctc_loss copies its lengths to the "
          f"host, which waits for the stream: this includes host time); "
          f"UniLSTM (cuDNN, fp32) over ({b}, {mel_len}, 384), forward and "
          f"backward: {lstm_ms:.3f} ms (device time)")
    return {f"timed steps {i + 1}": r["launches"]
            for i, r in enumerate(timed["xvector"])}, batch


def phase_conditioned_synthesis(gen) -> dict:
    """18(a), synthesis: the x-vector flagship in bf16 at B=8 / 2048 frames
    with 8 x-vectors (6 K1-90, counted from 0), timed; the same weights in
    fp32, each of the 8 rows against its solo call padded to the batch's
    shape (the engine's ``solo_at``), at ROW_TOL of max|ref|. Returns
    the bf16 call's launches."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    hp, model = flagship_model(DEVICE, amp=True, stacks=XVECTOR_COND)
    b, max_frames = 8, 2048
    text, pos = text_batch(gen, b, 128, 48, hp.vocab_size)
    text, pos = text.to(DEVICE), pos.to(DEVICE)
    spk = speaker_rows(gen, hp, b).to(DEVICE)
    hop = torch.randint(0, 3, (b,), generator=gen).to(DEVICE)

    set_counts({})                          # this path starts here
    mel, mel_len, _ = synthesize_fastspeech2(model, text, pos, max_frames,
                                             spk_emb=spk, hop_size=hop)
    torch.cuda.synchronize()
    launches = read_counts()                # and ends here
    check(launches["K1-90"] == hp.n_layer_decoder
          and all(n == 0 for k, n in launches.items() if k != "K1-90"),
          f"18(a) synthesis launches {json.dumps(launches)}")
    check(mel.shape == (b, max_frames, hp.mel_dim)
          and bool(torch.isfinite(mel.float()).all())
          and int(mel_len.min()) > 0, "18(a) synthesis output")
    _, plain = flagship_model(DEVICE, amp=True, stacks={})
    calls = {"x-vector": lambda: synthesize_fastspeech2(
                 model, text, pos, max_frames, spk_emb=spk, hop_size=hop),
             "plain": lambda: synthesize_fastspeech2(plain, text, pos,
                                                     max_frames)}
    walls = {name: [] for name in calls}
    for name in ("plain", "x-vector") * 2:     # in turn, for the host's drift
        walls[name].append(wall_ms(calls[name], 5, warmup=2)[0])
    ms = {name: statistics.median(v) for name, v in walls.items()}
    audio_s = mel_len.sum().item() * HOP_SECONDS
    print(f"18(a) x-vector synthesize_fastspeech2 B={b} L=128 max_frames="
          f"{max_frames} bf16 amp, 8 x-vectors: {ms['x-vector']:.3f} ms/call "
          f"(the mean of 2 runs' medians of 5, in turn with the plain "
          f"flagship's call on the same text: {ms['plain']:.3f} ms, "
          f"{ms['x-vector'] / ms['plain'] - 1:+.1%}), "
          f"{mel_len.sum().item()} frames = {audio_s:.3f} s audio, RTF "
          f"{ms['x-vector'] / 1e3 / audio_s:.6f}; launches "
          f"{json.dumps(launches)}")
    del model, plain, calls

    _, model = flagship_model(DEVICE, amp=False, stacks=XVECTOR_COND)
    with torch.no_grad():
        ref, ref_len, _ = synthesize_fastspeech2(
            model, text, pos, max_frames, spk_emb=spk, hop_size=hop)
    worst = 0.0
    for row in range(b):
        solo_text = torch.zeros_like(text)
        solo_pos = torch.zeros_like(pos)
        solo_spk = torch.zeros_like(spk)
        solo_hop = torch.zeros_like(hop)
        solo_text[0], solo_pos[0] = text[row], pos[row]
        solo_spk[0], solo_hop[0] = spk[row], hop[row]
        got, got_len, _ = synthesize_fastspeech2(
            model, solo_text, solo_pos, max_frames, spk_emb=solo_spk,
            hop_size=solo_hop)
        n = int(ref_len[row])
        check(int(got_len[0]) == n, f"18(a) row {row}: {int(got_len[0])} "
                                    f"frames alone, {n} in the batch")
        peak = max(1.0, ref[row, :n].abs().max().item())
        worst = max(worst, (got[0, :n] - ref[row, :n]).abs().max().item()
                    / peak)
    print(f"18(a) fp32 B={b} with 8 x-vectors: each row against its solo "
          f"call padded to the batch's shape, max|d mel| {worst:.3g} of "
          f"max|ref| (tol {ROW_TOL})")
    check(worst <= ROW_TOL, "18(a) a row differs from its solo call")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_conditioned_conformer(gen, batch) -> dict:
    """18(b): the conformer with 247 speaker ids in both stacks, accents,
    use_pos and use_rnn_length: card fp32 against CPU fp32 (K4, K5), then
    10 timed bf16 steps on ``batch`` (18(a)'s, at TRAIN_BATCH) with its
    conditioning (6 K4-d-90 and 6 K5-90 a step; the state kept for its
    profile), then synthesis at B=1 / 768 in bf16 (6 K4-90). Returns the
    timed steps' and the synthesis call's launches."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    phase_card_vs_cpu(gen, "spkconf")
    b, text_len, mel_len, _ = TRAIN_BATCH
    run = train_run("spkconf", conditioned(
        gen, trainer("spkconf")["hparams"](), batch))
    r = time_train_steps(run)
    PROFILES.append(partial(profile_train_step, run, r["ms"]))
    del run
    torch.cuda.empty_cache()
    print(f"18(b) speaker-id conformer train step B={b} L={text_len} "
          f"T={mel_len} bf16 amp dropout 0.1: {r['ms']:.3f} ms/step (median "
          f"of 10), {r['frames_s']:.0f} valid frames/s, the step's own peak "
          f"memory {r['own_gb']:.3f} GB; last losses {json.dumps(r['terms'])}"
          f"; launches per step {json.dumps(r['per_step'][0])}")

    hp, model = flagship_model(DEVICE, amp=True, stacks=SPKCONF_COND)
    text, pos = text_batch(gen, 1, 128, 128, hp.vocab_size)
    text, pos = text.to(DEVICE), pos.to(DEVICE)
    spk = speaker_rows(gen, hp, 1).to(DEVICE)
    accent = (torch.randint(0, 13, text.shape, generator=gen).to(DEVICE)
              * (text != 0))
    set_counts({})                          # this path starts here
    mel, mel_len, _ = synthesize_fastspeech2(model, text, pos, 768,
                                             spk_emb=spk, accent=accent)
    torch.cuda.synchronize()
    launches = read_counts()                # and ends here
    check(launches["K4-90"] == hp.n_layer_decoder
          and all(n == 0 for k, n in launches.items() if k != "K4-90"),
          f"18(b) synthesis launches {json.dumps(launches)}")
    check(bool(torch.isfinite(mel.float()).all()) and int(mel_len[0]) > 0,
          "18(b) synthesis output")
    ms, _ = wall_ms(lambda: synthesize_fastspeech2(
        model, text, pos, 768, spk_emb=spk, accent=accent), 10, warmup=2)
    print(f"18(b) speaker-id conformer synthesize_fastspeech2 B=1 L=128 "
          f"max_frames=768 bf16 amp: {ms:.3f} ms/call (median of 10), "
          f"{int(mel_len[0])} frames; launches {json.dumps(launches)}")
    del model
    torch.cuda.empty_cache()
    return {"timed steps": r["launches"], "synthesis": launches}


def phase_speaker_ar(gen):
    """18(c): the AR flagship with 247 speaker ids (``spk_emb_vers`` 1 in
    both stacks), bf16, max_steps AR_SPK_STEPS, no row stopping: graphed
    B=8 synthesis with 8 speakers equal to the eager loop bit for bit, a
    second graphed call with other speakers equal to its own eager call
    (a replay that kept the first call's speakers would fail it), ms per
    decode step beside the plain AR model's graph at the same shape; then
    ``spk_emb_vers`` 2 (x-vectors, ``spk_proj``) teacher-forced over
    AR_TF, card fp32 against CPU fp32 at 1e-3 of max(1, max|ref|)."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_transformer_tts)
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    from transformer_tts_tpu_torch.ops.masks import create_masks
    hp = ar_hparams(amp=True, **AR_SPK_COND)
    model = build_transformer_tts(hp, device=DEVICE).eval()
    _, plain = ar_model(DEVICE, amp=True)
    for m in (model, plain):
        with torch.no_grad():
            m.stop_token.bias.fill_(AR_STOP_BIAS)
    text, pos = text_batch(gen, 8, 128, 48, hp.vocab_size)
    text, pos = text.long().to(DEVICE), pos.to(DEVICE)
    speakers = [speaker_rows(gen, hp, 8).to(DEVICE) for _ in range(2)]
    set_counts({})                          # this path starts here
    outs = []
    for spk in speakers:
        g = synthesize_transformer_tts(model, text, pos, spk_emb=spk,
                                       max_steps=AR_SPK_STEPS)
        g = tuple(x.clone() for x in g)
        e = synthesize_transformer_tts(model, text, pos, spk_emb=spk,
                                       max_steps=AR_SPK_STEPS, eager=True)
        outs.append((g, e))
    torch.cuda.synchronize()
    launched = read_counts()                # and ends here
    check(not any(launched.values()), f"18(c) launched {launched}")
    for i, ((g_mel, g_len), (e_mel, e_len)) in enumerate(outs):
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len),
              f"18(c) graphed call {i + 1} differs from its eager call")
    d12 = (outs[0][0][0] - outs[1][0][0]).abs().max().item()
    check(d12 > 1e-3, "18(c) two speaker sets gave the same mel")
    runs = {"speakers": [], "plain": []}
    for name in ("plain", "speakers") * 2:      # in turn, for the host's drift
        m, kw = ((model, dict(spk_emb=speakers[0])) if name == "speakers"
                 else (plain, {}))
        runs[name].append(wall_ms(lambda: synthesize_transformer_tts(
            m, text, pos, max_steps=AR_SPK_STEPS, **kw), 3, warmup=1)[0])
    ms = {name: statistics.median(v) for name, v in runs.items()}
    print(f"18(c) AR with {N_SPEAKERS} speaker ids B=8 max_steps "
          f"{AR_SPK_STEPS} bf16: two graphed calls with other speakers, "
          f"each bit for bit its eager call (the two differ by up to "
          f"{d12:.3g}); median of 2 x 3 calls, in turn with the plain "
          f"model: {ms['speakers']:.3f} ms/call = "
          f"{ms['speakers'] / AR_SPK_STEPS:.4f} ms per decode step against "
          f"the plain AR model's {ms['plain']:.3f} ms = "
          f"{ms['plain'] / AR_SPK_STEPS:.4f} "
          f"({ms['speakers'] / ms['plain'] - 1:+.1%})")
    del model, plain
    torch.cuda.empty_cache()

    b, text_len, t = AR_TF
    hp2 = ar_hparams(amp=False, **AR_XVEC_V2)
    cpu_model = build_transformer_tts(hp2, device="cpu").eval()
    text, pos_text = text_batch(gen, b, text_len, 100, hp2.vocab_size)
    trg = torch.randn(b, t, hp2.mel_dim, generator=gen)
    masks = create_masks(pos_text, group_positions([t, t - 60], t),
                         model="transformer")
    spk = torch.randn(b, 512, generator=gen)
    with torch.no_grad():
        ref = cpu_model(text.long(), trg, *masks, spk_emb=spk)
    model = build_transformer_tts(hp2, device=DEVICE).eval()
    with torch.no_grad():
        out = model(text.long().to(DEVICE), trg.to(DEVICE),
                    *(x.to(DEVICE) for x in masks), spk_emb=spk.to(DEVICE))
    peak = max(1.0, ref.mel_post.abs().max().item())
    err = max((out.mel_post.cpu() - ref.mel_post).abs().max().item(),
              (out.stop_token.cpu() - ref.stop_token).abs().max().item())
    print(f"18(c) AR spk_emb_vers 2 teacher-forced B={b} L={text_len} "
          f"groups {t}: card fp32 vs CPU fp32 max|d| {err:.3g} (tol "
          f"{1e-3 * peak:.3g})")
    check(err <= 1e-3 * peak, "18(c) vers 2 card forward disagrees")
    del model, cpu_model
    torch.cuda.empty_cache()


def solo_with_speaker(engine, text, speaker, bucket: int):
    """The mel of ``text`` alone in ``speaker``'s voice, padded as the
    engine pads a batch to ``bucket``."""
    with engine.lock:
        mel, mel_len, _ = engine._run_padded(
            *engine._padded([text], engine.batch_size, bucket),
            engine._speakers([0], [speaker], engine.batch_size))
        return mel[0, :int(mel_len[0])].float().cpu().numpy()


def phase_speaker_engine(gen):
    """18(d): TTSEngine on 18(a)'s x-vector model in fp32 (SERVE): a
    mixed batch of 8 voices, each result against its solo call at its
    reported bucket; 4 requests through TTSServer with ``"speaker"``, each
    against its solo call; one stream with a speaker against its one-shot
    mel; all at SERVE_TOL of max|ref|."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.server import TTSServer
    _, model = flagship_model(DEVICE, amp=False, stacks=XVECTOR_COND)
    path = serving_dir("xvector_fp32", model, amp=False, **XVECTOR_COND)
    del model
    torch.cuda.empty_cache()
    engine = TTSEngine(path, **SERVE, device=DEVICE)
    engine.warmup()
    rs = np.random.RandomState(18)
    texts = serve_texts(rs, 8, 20, 60, 152)
    voices = [rs.randn(512).astype(np.float32) for _ in texts]
    t0 = time.perf_counter()
    results = engine.synthesize(texts, voices)
    ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for text, voice, res in zip(texts, voices, results):
        ref = solo_with_speaker(engine, text, voice, res["bucket"])
        check(ref.shape == res["mel"].shape, "18(d) solo length differs")
        worst = max(worst, np.abs(res["mel"] - ref).max()
                    / max(1.0, np.abs(ref).max()))

    server = TTSServer(engine, host="127.0.0.1", port=0)
    server.start()
    served = 0.0
    try:
        for text, voice in zip(texts[:4], voices[:4]):
            status, body = post_json(server.port, "/synthesize", {
                "text_ids": text, "speaker": voice.tolist()})
            check(status == 200, f"18(d) server status {status}")
            mel = np.asarray(json.loads(body)["mel"], np.float32)
            ref = solo_with_speaker(engine, text, voice,
                                    engine._bucket_of(len(text)))
            check(mel.shape == ref.shape, "18(d) served length differs")
            served = max(served, np.abs(mel - ref).max()
                         / max(1.0, np.abs(ref).max()))
    finally:
        server.stop()
    events = list(engine.synthesize_streaming(texts[0], voices[0]))
    mel = np.concatenate([e["mel"] for e in events if e["type"] == "mel"])
    one = engine.synthesize([texts[0]], [voices[0]])[0]["mel"]
    streamed = np.abs(mel - one).max() / max(1.0, np.abs(one).max())
    print(f"18(d) x-vector engine fp32, 8 requests in 8 voices: "
          f"{ms:.3f} ms for the call; each against its solo call at its "
          f"bucket within {worst:.3g} of max|ref|; 4 served requests with "
          f"\"speaker\" within {served:.3g}; a stream with a speaker within "
          f"{streamed:.3g} of its one-shot mel (tol {SERVE_TOL})")
    check(max(worst, served, streamed) <= SERVE_TOL,
          "18(d) the speaker engine's results differ")
    del engine
    torch.cuda.empty_cache()


def phase_conditioning(smi: str) -> dict:
    """Phase 18: speaker, accent and hop-size conditioning (data from a
    generator of seed 18). Returns the launches of its conditioned main
    paths (the timed train steps and the synthesis calls, each counted
    from 0), by kernel id."""
    gen = torch.Generator().manual_seed(18)
    training, batch = phase_conditioned_training(gen, smi)
    runs = [training, {"synthesis": phase_conditioned_synthesis(gen)},
            phase_conditioned_conformer(gen, batch)]
    phase_speaker_ar(gen)
    phase_speaker_engine(gen)
    total = {}
    for run in runs:
        for counts in run.values():
            for kid, n in counts.items():
                total[kid] = total.get(kid, 0) + n
    for kid in ("K1-90", "K1-d-90", "K2-90", "K4-90", "K4-d-90", "K5-90"):
        check(total.get(kid, 0) > 0, f"phase 18: {kid} did not launch")
    return total


# ---- phase 19: the other model families -------------------------------------

# two streams of vq-wav2vec's 320 codes, padded with 320 (the loss ignores
# it): the FastSpeech 2 head's 640 outputs are their logits
DISCRETE = dict(output_type="softmax", mel_dim=640)
CODE_PAD = 320
SQ_SPK_COND = dict(SQ_STACKS, is_multi_speaker=True,
                   spk_emb_type="speaker_id", spk_emb_dim=N_SPEAKERS,
                   spk_emb_architecture="encoder,decoder", accent_emb=True)
TACO_SYNTH_BATCHES = (1, 8)
# the card-vs-CPU step's batch: 63 decoder steps, each a few launches on
# the card and a few GEMMs on the CPU, in an eager loop
TACO_CPU_STEP_BATCH = (2, 128, 128, (100, 124))
TACO_STOP_BIAS = 30.0           # the stop rule fires at step 11: 15 groups
LM_TOKENS = (4, 400)            # B, T of the language model's forward


def taco_hparams(**overrides):
    """The AR flagship (egs/transformer_tts_ljspeech.py) with
    ``decoder_type = "tacotron2"``: d 384 for both stacks, r 2, LSTM cells
    1536 wide (gates 6144), prenet dropout 0.5, zoneout 0.1, with
    overrides."""
    return ar_hparams(**dict(overrides, decoder_type="tacotron2"))


def no_zoneout(model):
    """Zoneout (0.1, a constructor field, not an hparam) at 0, for the
    card-vs-CPU step."""
    model.decoder.zoneout_rate = 0.0


def discrete_hparams(**overrides):
    """The transformer flagship in the discrete mode (DISCRETE)."""
    return train_hparams(**dict(overrides, **DISCRETE))


def discrete_batch(gen, hp, b, text_len, mel_len, frames, device):
    """``train_batch``'s, its mel replaced by (B, T, 2) int32 codes drawn
    from ``gen`` (mel_dim / 2 classes), CODE_PAD past each row's frames,
    as the collate pads."""
    batch = train_batch(gen, hp, b, text_len, mel_len, frames, "cpu")
    codes = torch.randint(0, hp.mel_dim // 2, (b, mel_len, 2),
                          generator=gen, dtype=torch.int32)
    valid = (batch["pos_mel"] > 0)[..., None]
    batch["mel"] = torch.where(valid, codes, CODE_PAD)
    return {k: v.to(device) for k, v in batch.items()}


def other_trainer(kind: str) -> dict:
    """Phase 19's kinds: "tacotron2" (the AR flagship with the Tacotron 2
    decoder: no kernel, its attention weights held at GRAD_TOL, zoneout
    off in the card-vs-CPU step, at TACO_CPU_STEP_BATCH), "discrete" (the
    transformer flagship in the discrete mode, on code batches) and
    "sqspk" (the SQ-VAE FastSpeech 2 with SQ_SPK_COND, on batches with
    speakers and accents)."""
    if kind == "tacotron2":
        spec = trainer("ar")
        spec.update(hparams=taco_hparams, prepare=no_zoneout, kernels=(),
                    bf16_kernels=(), step_kernels=(), attn_tol=GRAD_TOL,
                    cpu_batch=TACO_CPU_STEP_BATCH,
                    live=("decoder.L_l1_", "decoder.L_l2_",
                          "decoder.Attention"))
    elif kind == "discrete":
        spec = trainer("fastspeech2")
        spec.update(hparams=discrete_hparams, batch=discrete_batch)
    else:
        spec = trainer("sq")

        def batch(gen, hp, *args):
            return conditioned(gen, hp, train_batch(gen, hp, *args))

        spec.update(hparams=lambda **o: train_hparams(**dict(o,
                                                             **SQ_SPK_COND)),
                    batch=batch,
                    live=spec["live"] + ("encoder.acc_embed.",
                                         "encoder.layers.0.spk_bias.",
                                         "decoder.layers.5.spk_bias."))
    return spec


def timed_other_step(kind, batch, smi, label) -> dict:
    """``train_run`` and ``time_train_steps`` of ``kind`` on ``batch`` at
    TRAIN_BATCH (kept for its profile, which gives the device's idle
    share); prints the step. Returns its launches."""
    b, text_len, mel_len, _ = TRAIN_BATCH
    run = train_run(kind, batch)
    r = time_train_steps(run)
    PROFILES.append(partial(profile_train_step, run, r["ms"]))
    del run
    torch.cuda.empty_cache()
    print(f"19{label} {kind} train step B={b} L={text_len} T={mel_len} "
          f"bf16 amp dropout 0.1: {r['ms']:.3f} ms/step (median of 10; "
          f"each {[round(x, 3) for x in r['step_ms']]}), "
          f"{r['frames_s']:.0f} valid frames/s, the step's own peak memory "
          f"{r['own_gb']:.3f} GB over {r['other_gb']:.3f} GB held besides; "
          f"last losses {json.dumps(r['terms'])}; launches per step "
          f"{json.dumps(r['per_step'][0])}; {smi}")
    return r["launches"]


def taco_graph_steps(model, b: int) -> int:
    """The steps the last graphed Tacotron 2 decode of batch ``b`` ran."""
    from transformer_tts_tpu_torch.infer import synthesize as synth
    return max(int(g.carry["step"])
               for key, g in synth._TACOTRON2_GRAPHS[model].items()
               if key[0] == b)


def phase_taco_synthesis(gen):
    """19(a), synthesis: ``synthesize_tacotron2`` of the Tacotron 2
    flagship, bf16 amp, max_steps 500, B=1 and B=8, no kernel launched:
    the loop replays CUDA graphs of 8 steps. The stop head's bias at
    AR_STOP_BIAS leaves the stop to the alignment rule (or the budget); the
    graph's mel and lengths must equal the eager loop's bit for bit, then
    again at TACO_STOP_BIAS, where the rule fires at step 11 and every
    row has 15 groups. Times (graph: median of 3; eager: one call): ms
    per call and per step run, RTF."""
    from transformer_tts_tpu_torch.infer import synthesize as synth
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    hp = taco_hparams(amp=True)
    model = build_transformer_tts(hp, device=DEVICE, seed=0).eval()
    r = hp.reduction_rate
    with torch.no_grad():
        model.decoder.TokenProj.bias.fill_(AR_STOP_BIAS)
    batches = []
    for b in TACO_SYNTH_BATCHES:
        text, pos = text_batch(gen, b, 128, 48, hp.vocab_size)
        batches.append((text.long().to(DEVICE), pos.to(DEVICE)))
    set_counts({})                          # the path starts here
    for text, pos in batches:
        t0 = time.perf_counter()
        mel, lengths = synth.synthesize_tacotron2(model, text, pos)
        torch.cuda.synchronize()
        print(f"19(a) Tacotron 2 synthesis B={text.shape[0]}: first graphed "
              f"call (warm-up and capture) "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        check(mel.shape == (text.shape[0], synth.MAX_AR_STEPS * r,
                            hp.mel_dim)
              and bool(torch.isfinite(mel).all())
              and len(set(lengths.tolist())) == 1 and int(lengths[0]) > 0,
              f"19(a) Tacotron 2 synthesis: mel {tuple(mel.shape)}, "
              f"lengths {lengths.tolist()}")
    launched = read_counts()                # and ends here
    check(not any(launched.values()),
          f"19(a) Tacotron 2 synthesis launched a kernel: {launched}")
    results, steps = {}, {}
    for text, pos in batches:
        b = text.shape[0]
        results[b, "graph"] = wall_ms(
            lambda: synth.synthesize_tacotron2(model, text, pos), 3)
        steps[b] = taco_graph_steps(model, b)
        results[b, "eager"] = wall_ms(
            lambda: synth.synthesize_tacotron2(model, text, pos,
                                               eager=True), 1)
        (g_mel, g_len), (e_mel, e_len) = (results[b, n][1]
                                          for n in ("graph", "eager"))
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len),
              f"19(a) Tacotron 2 B={b}: the graph's mel or lengths differ "
              f"from the eager loop's")
    with torch.no_grad():
        model.decoder.TokenProj.bias.fill_(TACO_STOP_BIAS)
    for text, pos in batches:
        g_mel, g_len = synth.synthesize_tacotron2(model, text, pos)
        e_mel, e_len = synth.synthesize_tacotron2(model, text, pos,
                                                  eager=True)
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len)
              and bool((g_len == 15 * r).all()),
              f"19(a) Tacotron 2 B={text.shape[0]} with the stop rule "
              f"firing: lengths graph {g_len.tolist()}, eager "
              f"{e_len.tolist()}")
    print(f"19(a) Tacotron 2, stop bias {TACO_STOP_BIAS}: every row "
          f"{15 * r} frames, the graph bit for bit the eager loop's")
    for (b, name), (ms, (_, lengths)) in sorted(results.items()):
        audio_s = lengths.sum().item() * HOP_SECONDS
        print(f"19(a) Tacotron 2 synthesize_tacotron2 B={b} L=128 max_steps "
              f"{synth.MAX_AR_STEPS} bf16 amp, {name}: {ms:.3f} ms/call "
              f"({'median of 3' if name == 'graph' else 'one call'}), "
              f"{steps[b]} steps run, {ms / steps[b]:.4f} ms per step, "
              f"{lengths.sum().item()} frames = {audio_s:.3f} s audio, RTF "
              f"{ms / 1e3 / audio_s:.6f}")
    del model
    torch.cuda.empty_cache()


def phase_language_model(gen):
    """19(b), the LSTM language model at its defaults (vocab 320, hidden
    512, 4 layers; cuDNN's fp32 LSTM on the card): the forward on the card
    against the CPU on the same weights and LM_TOKENS tokens, and its
    time."""
    from transformer_tts_tpu_torch.models.lm import (
        build_lstm_language_model)
    cpu = build_lstm_language_model(device="cpu", seed=0).eval()
    card = build_lstm_language_model(device=DEVICE, seed=0).eval()
    tokens = [torch.randint(0, cpu.out1.out_features, LM_TOKENS,
                            generator=gen) for _ in range(2)]
    with torch.no_grad():
        ref = cpu(*tokens)
        out = card(*(t.to(DEVICE) for t in tokens))
    err = max((o.cpu() - r).abs().max().item() for o, r in zip(out, ref))
    peak = max(r.abs().max().item() for r in ref)
    ms = time_ms(lambda: card(*(t.to(DEVICE) for t in tokens)), reps=10)
    print(f"19(b) LSTMLanguageModel (320, 512, 4 layers) forward over "
          f"{LM_TOKENS} tokens: card fp32 vs CPU fp32 max|d logits| "
          f"{err:.3g} (tol {1e-4 * max(1.0, peak):.3g}, max|ref| "
          f"{peak:.3g}); {ms:.3f} ms on the card")
    check(err <= 1e-4 * max(1.0, peak), "19(b) the LM's card forward "
                                        "disagrees with the CPU's")


def phase_sq_speaker_synthesis(gen) -> dict:
    """19(c), synthesis: the speaker SQ-VAE FastSpeech 2 in bf16 at B=8 /
    2048 frames with 8 speakers and accents (6 K1-90, counted from 0),
    timed; the same weights in fp32, each row against its solo call padded
    to the batch's shape, at ROW_TOL of max|ref|. Returns the bf16 call's
    launches."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    hp, model = flagship_model(DEVICE, amp=True, stacks=SQ_SPK_COND)
    b, max_frames = 8, 2048
    text, pos = text_batch(gen, b, 128, 48, hp.vocab_size)
    text, pos = text.to(DEVICE), pos.to(DEVICE)
    spk = speaker_rows(gen, hp, b).to(DEVICE)
    accent = (torch.randint(0, 5, text.shape, generator=gen).to(DEVICE)
              * (text != 0))
    cond = dict(spk_emb=spk, accent=accent)
    set_counts({})                          # this path starts here
    mel, mel_len, _ = synthesize_fastspeech2(model, text, pos, max_frames,
                                             **cond)
    torch.cuda.synchronize()
    launches = read_counts()                # and ends here
    check(launches["K1-90"] == hp.n_layer_decoder
          and all(n == 0 for k, n in launches.items() if k != "K1-90"),
          f"19(c) synthesis launches {json.dumps(launches)}")
    check(bool(torch.isfinite(mel.float()).all())
          and int(mel_len.min()) > 0, "19(c) synthesis output")
    ms, _ = wall_ms(lambda: synthesize_fastspeech2(
        model, text, pos, max_frames, **cond), 10, warmup=2)
    audio_s = mel_len.sum().item() * HOP_SECONDS
    del model
    _, model = flagship_model(DEVICE, amp=False, stacks=SQ_SPK_COND)
    with torch.no_grad():
        ref, ref_len, _ = synthesize_fastspeech2(model, text, pos,
                                                 max_frames, **cond)
    worst = 0.0
    for row in range(b):
        solo = [torch.zeros_like(x) for x in (text, pos, spk, accent)]
        for x, full in zip(solo, (text, pos, spk, accent)):
            x[0] = full[row]
        got, got_len, _ = synthesize_fastspeech2(
            model, solo[0], solo[1], max_frames, spk_emb=solo[2],
            accent=solo[3])
        n = int(ref_len[row])
        check(int(got_len[0]) == n, f"19(c) row {row}: {int(got_len[0])} "
                                    f"frames alone, {n} in the batch")
        peak = max(1.0, ref[row, :n].abs().max().item())
        worst = max(worst, (got[0, :n] - ref[row, :n]).abs().max().item()
                    / peak)
    print(f"19(c) speaker SQ-VAE synthesize_fastspeech2 B={b} L=128 "
          f"max_frames={max_frames} bf16 amp, 8 speakers and accents: "
          f"{ms:.3f} ms/call (median of 10), {mel_len.sum().item()} frames "
          f"= {audio_s:.3f} s audio, RTF {ms / 1e3 / audio_s:.6f}; "
          f"launches {json.dumps(launches)}; fp32: each row against its "
          f"solo call, max|d mel| {worst:.3g} of max|ref| (tol {ROW_TOL})")
    check(worst <= ROW_TOL, "19(c) a row differs from its solo call")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_other_families(smi: str) -> dict:
    """Phase 19 (data from a generator of seed 19): (a) the Tacotron 2
    decoder: card fp32 against CPU fp32, the bf16 step at TRAIN_BATCH
    (511 eager decoder steps, no kernel), graphed synthesis; (b) the
    discrete FastSpeech 2: card fp32 against CPU fp32, the bf16 step
    (K1-d-90, K2-90), the LSTM language model; (c) the SQ-VAE FastSpeech 2
    with 247 speaker ids and accents: card fp32 against CPU fp32 (the
    Gumbel noise drawn once), synthesis (K1-90). Its training CLIs run
    with phase 5's. Returns the launches of its main paths (the timed
    steps and the synthesis call), by kernel id."""
    gen = torch.Generator().manual_seed(19)
    b, text_len, mel_len, frames = TRAIN_BATCH
    t0 = time.perf_counter()
    phase_card_vs_cpu(gen, "tacotron2")
    batch = ar_train_batch(gen, taco_hparams(), b, text_len, mel_len,
                           frames, DEVICE)
    launches = [timed_other_step("tacotron2", batch, smi, "(a)")]
    phase_taco_synthesis(gen)
    t1 = time.perf_counter()
    phase_card_vs_cpu(gen, "discrete")
    batch = discrete_batch(gen, discrete_hparams(), b, text_len, mel_len,
                           frames, DEVICE)
    launches.append(timed_other_step("discrete", batch, smi, "(b)"))
    phase_language_model(gen)
    t2 = time.perf_counter()
    with fixed_gumbel(gen):
        phase_card_vs_cpu(gen, "sqspk")
    launches.append(phase_sq_speaker_synthesis(gen))
    print(f"phase 19 parts: (a) Tacotron 2 {t1 - t0:.1f} s, (b) discrete "
          f"{t2 - t1:.1f} s, (c) SQ speakers {time.perf_counter() - t2:.1f} "
          f"s")
    total = {}
    for counts in launches:
        for kid, n in counts.items():
            total[kid] = total.get(kid, 0) + n
    for kid in ("K1-90", "K1-d-90", "K2-90"):
        check(total.get(kid, 0) > 0, f"phase 19: {kid} did not launch")
    return total


# ---- phase 20: the kernels as custom ops, serving export -------------------

# an artifact's outputs against the engine's on the same inputs, of
# max(1, max|ref|): the artifact runs the engine's ops on the same kernels
EXPORT_TOL = 0.0
EXPORT_BUCKET = 128             # the flagship artifact's text bucket (1024
EXPORT_AR_BUCKET = 32           # frames); the AR one's (256 frames)
EXPORT_REPS = 3                 # timed calls of each artifact (the AR one's:
EXPORT_AR_REPS = 1              # its decode runs op by op, ~40 ms a step)
DISPATCH_CALLS = 2000
# artifacts in a fresh process: torch and the two ops modules only; the
# inputs and outputs go through .npz files, the timings and the kernel
# counters' deltas through its last line
ARTIFACT_LOADER = """
import json, statistics, sys, time
import numpy as np
import torch
import transformer_tts_tpu_torch.ops.flash_attention as fa
import transformer_tts_tpu_torch.ops.flash_relpos as fr
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
counters = ((fa.flash_attention, "sm90_launches"), (fa.flash_attention, "launches"),
            (fr.flash_relpos_attention, "sm90_launches"))
results = []
for path, inputs, outputs, reps in json.loads(sys.argv[1]):
    program = torch.export.load(path).module()
    args = [torch.from_numpy(x).cuda() for x in np.load(inputs).values()]
    with torch.no_grad():
        before = [getattr(o, a) for o, a in counters]
        out = program(*args)
        out = out if isinstance(out, (tuple, list)) else (out,)
        torch.cuda.synchronize()
        launched = [getattr(o, a) - b for (o, a), b in zip(counters, before)]
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            program(*args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    np.savez(outputs, *[(o.float() if o.is_floating_point() else o).cpu().numpy()
                        for o in out])
    results.append({"ms": statistics.median(walls), "K1-90": launched[0],
                    "K1": launched[1], "K4-90": launched[2]})
print(json.dumps(results))
"""


# what opcheck tests of the backward ops, which no autograd runs through
# (their forward ops get every test, aot_dispatch_dynamic included)
BWD_OPCHECKS = ("test_schema", "test_faketensor")


def opcheck_ops(gen) -> int:
    """``torch.library.opcheck`` of every ``tts_port`` op on the card, at
    one small bf16 shape (the Hopper design, the fused backwards too:
    plain with dropout, causal, and with a bias and dropout) and one fp32
    shape (the simple design, with dropout); the relative ops alike; each
    backward op with every value of its ``kernel`` argument that the
    dtype takes. Returns the number of checks; the launches they make are not
    counted."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    saved, n = read_counts(), 0
    b, h, t, d = 2, 2, 64, 64
    cases = {torch.bfloat16: ((False, False, 0.1), (True, False, 0.0),
                              (False, True, 0.1)),
             torch.float32: ((False, False, 0.1),)}
    for dtype, modes in cases.items():
        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(DEVICE, dtype)
        k_len = torch.tensor([t, 40], dtype=torch.int32, device=DEVICE)
        kernels = ("auto", "simple", "dq", "dkdv") + (
            ("sm90",) if dtype == torch.bfloat16 else ())
        for causal, with_bias, rate in modes:
            q, k, v, do = (rnd(b, h, t, d) for _ in range(4))
            bias = rnd(b, h, t, t) if with_bias else None
            args = (q.requires_grad_(), k.requires_grad_(),
                    v.requires_grad_(), k_len, bias, d ** -0.5, rate,
                    DROPOUT_SEED, causal, "auto")
            torch.library.opcheck(fa._flash_fwd_op, args)
            o, lse = (x.detach() for x in fa._flash_fwd_op(*args))
            plain = [x.detach() for x in (q, k, v)]
            delta = fa.bwd_delta(o, do)
            for kernel in kernels:
                torch.library.opcheck(fa._flash_bwd_op, (
                    *plain, do, lse, delta, k_len, bias, d ** -0.5, rate,
                    DROPOUT_SEED, causal, kernel), test_utils=BWD_OPCHECKS)
            n += 1 + len(kernels)
        xs = [rnd(b, h, t, d) for _ in range(5)]
        p = rnd(h, t, d)
        args = (*(x.requires_grad_() for x in xs[:4]), p.requires_grad_(),
                k_len, d ** -0.5, 0.1, DROPOUT_SEED, "auto")
        torch.library.opcheck(fr._relpos_fwd_op, args)
        o, lse = (x.detach() for x in fr._relpos_fwd_op(*args))
        plain = [x.detach() for x in (*xs[:4], p)]
        delta = fr.bwd_delta(o, xs[4])
        for kernel in kernels:
            torch.library.opcheck(fr._relpos_bwd_op, (
                *plain, xs[4], lse, delta, k_len, d ** -0.5, 0.1,
                DROPOUT_SEED, kernel), test_utils=BWD_OPCHECKS)
        n += 1 + len(kernels)
    set_counts(saved)
    return n


def dispatch_us() -> tuple:
    """Host µs per K1-90 launch through ``tts_port::flash_fwd`` and through
    its CUDA implementation called directly, on a (1, 1, 256, 64) bf16
    input, each the mean of DISPATCH_CALLS calls ended by one
    synchronize."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    saved = read_counts()
    q = torch.randn(1, 1, 256, 64, device=DEVICE, dtype=torch.bfloat16)
    k_len = torch.tensor([256], dtype=torch.int32, device=DEVICE)
    out = []
    for call in (lambda: fa._forward(q, q, q, k_len, 0.125, 0.0, 0, False),
                 lambda: fa._forward_cuda(q, q, q, k_len, None, 0.125, 0.0,
                                          0, False, "auto")):
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
    set_counts(saved)
    return tuple(out)


def start_artifacts(items: list) -> tuple:
    """Each (path, inputs, reps) of ``items`` loaded and called in one
    fresh ``python3`` (ARTIFACT_LOADER) on its inputs, started here:
    (the process, what ``finish_artifacts`` reads)."""
    spec = []
    for path, inputs, reps in items:
        stem = os.path.splitext(path)[0]
        np.savez(stem + "_in.npz", *[x.cpu().numpy() for x in inputs])
        spec.append((path, stem + "_in.npz", stem + "_out.npz", reps))
    proc = subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_LOADER, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return proc, spec


def finish_artifacts(started: tuple) -> list:
    """``start_artifacts``' process waited for: [(each artifact's
    outputs, {"ms": median of its ``reps`` calls after one counted, the
    K1-90, K1 and K4-90 launches of that one})]."""
    proc, spec = started
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"loading {[s[0] for s in spec]} in a "
                                f"fresh process failed: {err[-3000:]}")
    stats = json.loads(out.strip().splitlines()[-1])
    return [([torch.from_numpy(x) for x in np.load(o).values()], st)
            for (_, _, o, _), st in zip(spec, stats)]


def exported_engine(name: str, model, overrides: dict, bucket: int, **kw):
    """A TTSEngine at batch 8 on ``model``'s checkpoint (written under
    ``WORK/serving/name`` with FLAGSHIP's hparams and ``overrides``), its
    one bucket's artifact (and a vocoder's) exported into
    ``WORK/export/name``: (engine, manifest, out dir, export seconds)."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    engine = TTSEngine(serving_dir(name, model, **overrides), batch_size=8,
                       frames_per_phone=8, text_buckets=(bucket,),
                       device=DEVICE, **kw)
    out_dir = os.path.join(WORK, "export", name)
    t0 = time.perf_counter()
    manifest = engine.export(out_dir)
    return engine, manifest, out_dir, time.perf_counter() - t0


def export_ar_engine(texts) -> tuple:
    """``exported_engine`` of the AR flagship at LATER_DEPTH at bucket
    EXPORT_AR_BUCKET, exported after its stop head was set on the eager
    decode of ``texts`` (``staggered_stop_weight``, then
    ``stopping_bias``; at this depth the draw's stop logit peaks in every
    row's first steps) so that its rows stop at different steps before the
    bucket's budget: the artifact's while_loop then ends at the last row's
    stop, the engine's decode at the end of that block of DONE_CHECK_EVERY
    steps."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_transformer_tts)
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    model = build_transformer_tts(ar_hparams(amp=True, **LATER_DEPTH),
                                  device=DEVICE).eval()
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    engine = TTSEngine(serving_dir("export_ar", model, model="Transformer",
                                   **LATER_DEPTH),
                       batch_size=8, frames_per_phone=8,
                       text_buckets=(EXPORT_AR_BUCKET,), device=DEVICE)
    steps = (engine.max_frames_for(EXPORT_AR_BUCKET)
             // engine.hp.reduction_rate)
    store = []
    head = engine.model.stop_token
    with engine.lock, torch.no_grad():
        with stop_logits(engine.model, store) as seen:
            synthesize_transformer_tts(
                engine.model, *engine._padded(texts, 8, EXPORT_AR_BUCKET),
                max_steps=steps, eager=True)
            head.weight.copy_(staggered_stop_weight(torch.stack(seen), steps)
                              .to(head.weight)[None].expand_as(head.weight))
        # every row stops in the first three quarters of the budget
        head.bias.fill_(stopping_bias(store[0][:3 * steps // 4], steps))
    out_dir = os.path.join(WORK, "export", "export_ar")
    t0 = time.perf_counter()
    manifest = engine.export(out_dir)
    return engine, manifest, out_dir, time.perf_counter() - t0


def phase_export(gen, smi: str):
    """Phase 20: every ``tts_port`` op through opcheck on the card; the
    op's host cost per launch; the flagship FastSpeech 2 engine (B=8,
    bucket 128, 1024 frames, with HiFi-GAN V1) and the AR engine (B=8,
    bucket 32, a budget of 128 decode steps, its rows stopping at
    different steps before it: ``export_ar_engine``) exported, each engine's
    artifacts loaded and called in a fresh process on the engine's inputs
    and held against the engine: shapes, lengths and durations equal, the
    mel and the samples within EXPORT_TOL of max(1, max|ref|), the
    flagship artifact on K1-90 (its process's counter: one launch per
    decoder layer); call times beside the engine's. The AR engine runs at
    LATER_DEPTH: its artifact's decode runs op by op (~40 ms a step at
    full depth)."""
    from transformer_tts_tpu_torch.infer.streaming import vocode_pinned
    print(smi)
    t0 = time.perf_counter()
    n = opcheck_ops(gen)
    print(f"20 opcheck: {n} checks of the four tts_port ops on the card "
          f"(bf16: plain, causal, bias; fp32: plain; the relative ops; "
          f"each backward op with every kernel argument) "
          f"passed in {time.perf_counter() - t0:.1f} s")
    op_us, direct_us = dispatch_us()
    print(f"20 dispatch: K1-90 through tts_port::flash_fwd {op_us:.2f} us "
          f"per launch on the host, its CUDA implementation called "
          f"directly {direct_us:.2f} us: the op adds "
          f"{op_us - direct_us:.2f} us")

    _, model = flagship_model(DEVICE, amp=True, stacks={})
    voc_dir = os.path.join(WORK, "serving", "vocoder")
    fs2, manifest, out_dir, seconds = exported_engine(
        "export_fastspeech2", model, {}, EXPORT_BUCKET, vocoder=voc_dir)
    rs = np.random.RandomState(20)
    texts = serve_texts(rs, 8, EXPORT_BUCKET // 2 + 1, EXPORT_BUCKET, 152)
    ar_texts = serve_texts(rs, 8, EXPORT_AR_BUCKET // 2 + 1,
                           EXPORT_AR_BUCKET, 152)
    inputs = fs2._padded(texts, 8, EXPORT_BUCKET)
    ms, want = wall_ms(lambda: fs2._run_padded(*inputs), EXPORT_REPS,
                       warmup=1)
    (budget, entry), = manifest["vocoder"]["budgets"].items()
    check(manifest["vocoder"]["allow_tf32"] is False, "20: vocoder manifest")
    mel = want[0].float()           # the vocoder's input (B, T, mel) fp32
    v_ms, v_want = wall_ms(lambda: vocode_pinned(fs2._vocoder, mel),
                           EXPORT_REPS, warmup=1)
    # the fresh process runs beside the AR engine's export (host work)
    started = start_artifacts([
        (os.path.join(out_dir, manifest["buckets"][str(EXPORT_BUCKET)][
            "file"]), inputs, EXPORT_REPS),
        (os.path.join(out_dir, entry["file"]), [mel], EXPORT_REPS)])
    try:
        ar_export = export_ar_engine(ar_texts)
        (got, stats), (v_got, v_stats) = finish_artifacts(started)
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()
    err = max_err(got[0], want[0].cpu())
    print(f"20 fastspeech2 artifact B=8 bucket {EXPORT_BUCKET} "
          f"({fs2.max_frames_for(EXPORT_BUCKET)} frames), exported in "
          f"{seconds:.1f} s with its vocoder: a fresh process's call "
          f"{stats['ms']:.3f} ms against the engine's {ms:.3f} ms (median "
          f"of {EXPORT_REPS}); mel max|d| {err[0]:.3g} of max|ref| "
          f"{err[1]:.3g} (bit for bit: "
          f"{torch.equal(got[0], want[0].cpu().float())}); lengths and "
          f"durations equal: "
          f"{[torch.equal(g, w.cpu()) for g, w in zip(got[1:], want[1:])]}"
          f"; launches in the artifact's call {json.dumps(stats)}")
    check(got[0].shape == want[0].shape
          and err[0] <= EXPORT_TOL * max(1.0, err[1])
          and all(torch.equal(g, w.cpu()) for g, w in zip(got[1:], want[1:])),
          "20: the fastspeech2 artifact differs from the engine")
    check(stats["K1-90"] == fs2.hp.n_layer_decoder and stats["K1"] == 0,
          f"20: the fastspeech2 artifact did not run K1-90 once per "
          f"decoder layer: {stats}")

    v_err = max_err(v_got[0], v_want.cpu())
    print(f"20 vocoder artifact B=8 at {budget} frames, TF32 off: a fresh "
          f"process's call {v_stats['ms']:.3f} ms against vocode_pinned's "
          f"{v_ms:.3f} ms; samples max|d| {v_err[0]:.3g} of max|ref| "
          f"{v_err[1]:.3g} (bit for bit: "
          f"{torch.equal(v_got[0], v_want.cpu())})")
    check(v_got[0].shape == v_want.shape
          and v_err[0] <= EXPORT_TOL * max(1.0, v_err[1]),
          "20: the vocoder artifact differs from vocode_pinned")
    del fs2, model
    torch.cuda.empty_cache()

    from transformer_tts_tpu_torch.infer.synthesize import DONE_CHECK_EVERY
    ar, manifest, out_dir, seconds = ar_export
    inputs = ar._padded(ar_texts, 8, EXPORT_AR_BUCKET)
    budget = ar.max_frames_for(EXPORT_AR_BUCKET) // ar.hp.reduction_rate
    ms, want = wall_ms(lambda: ar._run_padded(*inputs), EXPORT_REPS,
                       warmup=1)
    (got, stats), = finish_artifacts(start_artifacts([(os.path.join(
        out_dir, manifest["buckets"][str(EXPORT_AR_BUCKET)]["file"]),
        inputs, EXPORT_AR_REPS)]))
    err = max_err(got[0], want[0].cpu())
    # the steps each decode ran: the loop to the last row's stop, the
    # engine's graphs to the end of that block
    steps = -(-int(want[1].max()) // ar.hp.reduction_rate)
    blocks = min(budget, -(-steps // DONE_CHECK_EVERY) * DONE_CHECK_EVERY)
    print(f"20 transformer_tts artifact B=8 bucket {EXPORT_AR_BUCKET} "
          f"(a budget of {budget} decode steps, one torch.while_loop; "
          f"{ar.hp.n_layer_encoder} + {ar.hp.n_layer_decoder} layers), "
          f"exported in {seconds:.1f} s; rows stopping at lengths "
          f"{want[1].tolist()}: a fresh process's call {stats['ms']:.3f} "
          f"ms (median of {EXPORT_AR_REPS}) = "
          f"{stats['ms'] / steps:.4f} ms per step over its {steps} steps "
          f"against the engine's graphed decode {ms:.3f} ms = "
          f"{ms / blocks:.4f} ms per step over its {blocks}; mel "
          f"max|d| {err[0]:.3g} of max|ref| {err[1]:.3g} (bit for bit: "
          f"{torch.equal(got[0], want[0].cpu().float())}); lengths "
          f"{got[1].tolist()} against {want[1].tolist()}; launches "
          f"{json.dumps(stats)}")
    check(steps < budget and len(set(want[1].tolist())) > 1,
          f"20: the stop bias did not stop the AR rows early at different "
          f"steps: {want[1].tolist()}")
    check(got[0].shape == want[0].shape
          and err[0] <= EXPORT_TOL * max(1.0, err[1])
          and torch.equal(got[1], want[1].cpu()),
          "20: the transformer_tts artifact differs from the engine")
    del ar
    torch.cuda.empty_cache()


# ---- phase 21: data parallelism, sequence parallelism, RAdam, remat --------

DDP_WORLD = 2
DDP_STEPS = 3
# each logged term of the DDP steps (the losses, the grad norm) against
# one process's on the whole batch: within this many times the same-run
# control (the single process run twice: K2-90's dq atomics add in
# another order each run), and never held tighter than DDP_FLOOR of the
# value (the ranks' fp32 sums and the cuBLAS kernels picked for 8 rows
# instead of 16 round otherwise: grad norms 6e-5 to 4.3e-4 off in my
# first card run, losses 1e-7 to 2e-6). The planted fault (each rank's
# BatchNorms on its own rows) moves loss_frame_after by ~5e-3 at small
# sizes on the CPU; whether the card's check sees it is printed.
DDP_OF_CONTROL = 10.0
DDP_FLOOR = 1e-3
SP_T = 2048                     # the sequence split over 2 ranks: T_q 1024
REMAT_STEPS = 2
# each rank's runs: DDP, the planted per-rank statistics, DDP with remat
RANK_RUNS = ("ddp", "fault", "remat")
RADAM_STEPS = 7                 # the first 5 degenerate to momentum SGD

DDP_RANK = """
import json, sys
import torch
import torch.distributed as dist
import chip_smoke as cs
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=cs.DDP_WORLD, rank=rank)
try:
    settings = json.loads(sys.argv[4])
    cs.FLAGSHIP.update(settings["flagship"])
    cs.DEVICE = settings["device"]
    print(json.dumps(cs.ddp_rank(rank, work)))
finally:
    dist.destroy_process_group()
"""


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_hparams(**overrides):
    """The transformer flagship with every dropout 0 (the comparison's)."""
    return train_hparams(**dict(dict(dropout=0.0, dropout_postnet=0.0,
                                     dropout_variance_adaptor=0.0),
                                **overrides))


def ddp_batch(gen) -> dict:
    """TRAIN_BATCH on the CPU, its rows sorted by valid frames, so rank 0's
    8 rows hold more of them than rank 1's."""
    b, text_len, mel_len, frames = TRAIN_BATCH
    batch = train_batch(gen, ddp_hparams(), b, text_len, mel_len, frames,
                        "cpu")
    order = torch.argsort((batch["pos_mel"] > 0).sum(1), descending=True)
    return {k: v[order] for k, v in batch.items()}


def running_moves(model, before: dict) -> dict:
    """{name: how far each BatchNorm running statistic moved} (fp32, on
    the CPU) since ``before``, the initial ``state_dict``."""
    return {k: v.float().cpu() - before[k].float()
            for k, v in model.state_dict().items()
            if "running_mean" in k or "running_var" in k}


def ddp_steps(state, step, batch, before: dict) -> dict:
    """DDP_STEPS steps of ``state`` on ``batch``, the launch counts set to
    0 before: {logs: every logged term per step, launches, moves: the
    running statistics' moves from ``before``}."""
    set_counts({})
    logs = []
    for _ in range(DDP_STEPS):
        state, out = step(state, batch)
        logs.append({k: float(v) for k, v in out.items()})
    if DEVICE != "cpu":         # a CPU rehearsal's rank process
        torch.cuda.synchronize()
    return dict(logs=logs, launches=read_counts(),
                moves=running_moves(state.model, before))


def ddp_rank(rank: int, work: str) -> dict:
    """A rank of 21(a), in its own process: the flagship from the saved
    initial weights, wrapped by ``train.trainer.distribute`` over the
    gloo group, DDP_STEPS steps on its half of the saved batch; then the
    same from the same weights with the planted fault (each rank's
    BatchNorms on its own rows' statistics), and with ``remat`` (the
    checkpoint inside the module DDP wraps)."""
    from transformer_tts_tpu_torch.parallel import set_norm_group
    from transformer_tts_tpu_torch.train import trainer as tr
    batch = torch.load(os.path.join(work, "batch.pt"))
    init = torch.load(os.path.join(work, "init.pt"))
    half = batch["text"].shape[0] // DDP_WORLD
    mine = {k: v[rank * half:(rank + 1) * half].to(DEVICE)
            for k, v in batch.items()}
    out = {"valid_frames": int((mine["pos_mel"] > 0).sum())}
    for name in RANK_RUNS:
        hp = ddp_hparams(remat=name == "remat")
        state = tr.init_fastspeech2_state(hp, device=DEVICE)
        state.model.load_state_dict(init)
        state = tr.distribute(state, DEVICE)
        if name == "fault":
            set_norm_group(state.model, None)
        out[name] = ddp_steps(
            state, tr.make_fastspeech2_train_step(hp, device=DEVICE), mine,
            init)
        del state
    # the moves go through a file: JSON would round them
    torch.save({name: out[name].pop("moves") for name in RANK_RUNS},
               os.path.join(work, f"moves{rank}.pt"))
    return out


def start_ranks(work: str) -> list:
    """The DDP_WORLD rank processes of 21(a), on the one card."""
    port = str(free_port())
    settings = json.dumps({"flagship": FLAGSHIP, "device": DEVICE})
    return [subprocess.Popen([sys.executable, "-c", DDP_RANK, str(r), port,
                              work, settings], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for r in range(DDP_WORLD)]


def finish_ranks(procs: list) -> list:
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"21(a) rank {r}: exit "
                                        f"{proc.returncode}: {err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# the least allowance of the running statistics' moves, of the largest
# move of each buffer (bf16 activations round the statistics)
MOVES_FLOOR = 1e-3


def moves_off(got: dict, ref: dict) -> float:
    """The largest |got - ref| of a BatchNorm buffer's moves over that
    buffer's largest move in ``ref``."""
    return max(float((got[k] - ref[k]).abs().max())
               / max(float(ref[k].abs().max()), 1e-30) for k in ref)


def phase_ddp_vs_single(gen) -> dict:
    """21(a): two gloo ranks on the one card (separate processes: NCCL
    takes one rank per card) against one process on the whole batch;
    (c)'s checks and (d) run meanwhile, (c)'s times once the ranks have
    ended. Returns the launches of the ranks' and (d)'s main paths,
    summed."""
    from transformer_tts_tpu_torch.train import trainer as tr
    work = os.path.join(WORK, "ddp")
    os.makedirs(work, exist_ok=True)
    batch = ddp_batch(gen)
    hp = ddp_hparams()
    init = tr.init_fastspeech2_state(hp, device=DEVICE)
    torch.save({k: v.cpu() for k, v in init.model.state_dict().items()},
               os.path.join(work, "init.pt"))
    torch.save(batch, os.path.join(work, "batch.pt"))
    del init
    t0 = time.perf_counter()
    procs = start_ranks(work)
    try:
        single = []
        init = torch.load(os.path.join(work, "init.pt"))
        for _ in range(2):          # the run and its same-run control
            state = tr.init_fastspeech2_state(hp, device=DEVICE)
            state.model.load_state_dict(init)
            single.append(ddp_steps(
                state, tr.make_fastspeech2_train_step(hp, device=DEVICE),
                {k: v.to(DEVICE) for k, v in batch.items()}, init))
            del state
        torch.cuda.empty_cache()
        extra = ddp_remaining()
    finally:
        ranks = finish_ranks(procs)
    seconds = time.perf_counter() - t0
    extra["time_sp"]()          # on the card the ranks have left
    a, b = single
    print(f"21(a) {DDP_WORLD} gloo ranks on one card, the flagship "
          f"({hp.n_layer_encoder} + {hp.n_layer_decoder} layers, bf16 amp, "
          f"dropout 0), TRAIN_BATCH split 8 + 8 with "
          f"{[r['valid_frames'] for r in ranks]} valid frames, "
          f"{DDP_STEPS} steps, {seconds:.1f} s with the ranks' start; "
          f"rank launches " + json.dumps(
              [{k: v for k, v in r["ddp"]["launches"].items() if v}
               for r in ranks]))
    worst = {name: 0.0 for name in RANK_RUNS}
    for i in range(DDP_STEPS):
        for key in sorted(a["logs"][i]):
            ref = a["logs"][i][key]
            control = rel(b["logs"][i][key], ref)
            tol = max(DDP_OF_CONTROL * control, DDP_FLOOR)
            got = {name: max(rel(r[name]["logs"][i][key], ref)
                             for r in ranks) for name in worst}
            for name in worst:
                worst[name] = max(worst[name], got[name] / tol)
            print(f"21(a) step {i + 1} {key}: one process {ref:.7g}, "
                  f"control {control:.3g}; the ranks "
                  f"{ranks[0]['ddp']['logs'][i][key]:.7g} ({got['ddp']:.3g}"
                  f"), per-rank statistics "
                  f"{ranks[0]['fault']['logs'][i][key]:.7g} "
                  f"({got['fault']:.3g}), remat "
                  f"{ranks[0]['remat']['logs'][i][key]:.7g} "
                  f"({got['remat']:.3g}); allowed {tol:.3g}")
    print(f"21(a) the worst term over its allowance: DDP {worst['ddp']:.3g}, "
          f"the planted per-rank statistics {worst['fault']:.3g}, DDP with "
          f"remat {worst['remat']:.3g}")
    check(worst["ddp"] <= 1.0, "21(a): the DDP steps differ from one "
                               "process's past their allowance")
    check(worst["remat"] <= 1.0, "21(a): the DDP remat steps differ from "
                                 "one process's past their allowance")
    print(f"21(a) the planted per-rank statistics "
          f"{'fail' if worst['fault'] > 1.0 else 'pass'} the logs' check")
    # the statistics the BatchNorms used, read off their running
    # averages: the same on both ranks, and one process's moves
    moves = [torch.load(os.path.join(work, f"moves{r}.pt"))
             for r in range(DDP_WORLD)]
    same = {name: all(torch.equal(moves[0][name][k], moves[1][name][k])
                      for k in moves[0][name]) for name in worst}
    control = max(moves_off(b["moves"], a["moves"]), MOVES_FLOOR)
    off = {name: max(moves_off(m[name], a["moves"]) for m in moves)
           for name in worst}
    print(f"21(a) BatchNorm running statistics after {DDP_STEPS} steps "
          f"({len(a['moves'])} buffers): the ranks' equal bit for bit: "
          f"DDP {same['ddp']}, per-rank statistics {same['fault']}, remat "
          f"{same['remat']}; their moves off one process's by "
          f"{off['ddp']:.3g} (DDP), {off['fault']:.3g} (per-rank "
          f"statistics) and {off['remat']:.3g} (remat) of its largest move, "
          f"the control by {moves_off(b['moves'], a['moves']):.3g}; allowed "
          f"{DDP_OF_CONTROL * control:.3g}")
    for name in ("ddp", "remat"):
        check(same[name] and off[name] <= DDP_OF_CONTROL * control,
              f"21(a): the {name} ranks' BatchNorm statistics are not the "
              "global batch's")
    check(not same["fault"] and off["fault"] > DDP_OF_CONTROL * control,
          "21(a): the planted per-rank statistics pass the BatchNorm "
          "statistics' check: it cannot see them")
    n = DDP_STEPS * hp.n_layer_decoder
    for r, out in enumerate(ranks):
        got = out["ddp"]["launches"]
        check(got["K1-90"] == n and got["K2-90"] == n,
              f"21(a): rank {r} launched {got}, not {n} K1-90 and K2-90")
    summed = {}
    for counts in [r["ddp"]["launches"] for r in ranks] + [
            extra["launches"]]:
        for k, v in counts.items():
            summed[k] = summed.get(k, 0) + v
    return summed


def ddp_remaining() -> dict:
    """21(d) and (c)'s checks, run in the main process while the ranks of
    21(a) work: {launches of (d)'s main paths, time_sp: (c)'s timing, to
    run once the ranks have ended}."""
    launches = phase_remat_and_radam()
    return {"launches": launches, "time_sp": phase_sp_kernels()}


def phase_sp_kernels():
    """21(c): K1-90 and K2-90 at sequence parallelism's per-rank shapes
    (T_q = SP_T / 2 against T_k = SP_T, a batch's k_len) against their
    plain versions, and the two halves' O against the whole sequence's.
    Returns the function that times them, to be called on a card that
    nothing else uses."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator().manual_seed(21)
    b, h, d = TRAIN_BATCH[0], 4, 96
    k_len = torch.randint(SP_T // 2, SP_T + 1, (b,), generator=gen,
                          dtype=torch.int32).to(DEVICE)
    q, k, v, do = (torch.randn(b, h, SP_T, d, generator=gen).to(DEVICE)
                   .to(torch.bfloat16) for _ in range(4))
    n = SP_T // DDP_WORLD
    for rate in (0.0, 0.1):
        for r in range(DDP_WORLD):
            rows = slice(r * n, (r + 1) * n)
            errs, peaks, _ = check_train_kernels(
                q[:, :, rows].contiguous(), k, v,
                do[:, :, rows].contiguous(), k_len, rate,
                label=f" at SP rank {r}'s shape")
            print(f"21(c) K1{'-d' if rate else ''}-90/K2-90 at rank {r}'s "
                  f"shape ({b},{h},{n},{SP_T},{d}) bf16 rate {rate}: "
                  + " ".join(f"max|d{m}|={e:.3g} (max|ref| {peaks[m]:.3g})"
                             for m, e in errs.items()))
    counts = read_counts()
    with torch.no_grad():
        whole, _ = fa.flash_attention(q, k, v, k_len)
        halves = torch.cat([fa.flash_attention(
            q[:, :, r * n:(r + 1) * n].contiguous(), k, v, k_len)[0]
            for r in range(DDP_WORLD)], dim=2)
    torch.cuda.synchronize()
    set_counts(counts)
    err, peak = max_err(halves, whole)
    print(f"21(c) the {DDP_WORLD} halves' O concatenated against the whole "
          f"sequence's: max|d| {err:.3g} of max|ref| {peak:.3g} (bit for "
          f"bit: {torch.equal(halves, whole)})")
    check(err <= REL_TOL[torch.bfloat16] * peak,
          "21(c): the halves' O differ from the whole sequence's")
    q_half = q[:, :, :n].contiguous()
    do_half = do[:, :, :n].contiguous()
    del q, do, whole, halves     # the timing keeps what it reads

    def timing():
        counts = read_counts()
        fwd_ms = time_ms(lambda: fa.flash_attention(q_half, k, v, k_len))
        o, lse = fa.flash_attention(q_half, k, v, k_len)
        bwd_ms = time_ms(lambda: fa.flash_attention_bwd(
            q_half, k, v, o, lse, do_half, k_len, sm_scale=d ** -0.5))
        keys = k_len.double().sum().item()
        nbytes = (q_half.numel() * 2 + k.numel() * 2) * 2
        fwd_bound = bound_ms(4 * h * n * keys * d, nbytes + b * h * n * 4,
                             torch.bfloat16)
        bwd_bound = bound_ms(10 * h * n * keys * d,
                             nbytes * 2 + b * h * n * 8, torch.bfloat16)
        set_counts(counts)
        print(f"21(c) at ({b},{h},{n},{SP_T},{d}) bf16, the ranks of 21(a) "
              f"ended: K1-90 {fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f}, "
              f"{fwd_bound[1]}), K2-90 {bwd_ms:.4f} ms (bound "
              f"{bwd_bound[0]:.4f}, {bwd_bound[1]})")

    return timing


def step_peak(state, step, batch, n: int) -> tuple:
    """(losses, grad norms, the steps' own peak GB) of ``n`` steps."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, norms = [], []
    for _ in range(n):
        state, logs = step(state, batch)
        losses.append(float(logs["loss_total"]))
        norms.append(float(logs["grad_norm"]))
    torch.cuda.synchronize()
    return losses, norms, (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_remat_and_radam() -> dict:
    """21(d): the flagship's remat step with dropout 0.1 against the plain
    step on the same seeds (and a second plain run, the control), its
    peak memory beside the plain step's and the running statistics moved
    once a step; then RAdam's steps, the first an SGD step of lr x the
    clipped gradient. Returns the launches of these main paths."""
    from transformer_tts_tpu_torch.train import trainer as tr
    gen = torch.Generator().manual_seed(210)
    b, text_len, mel_len, frames = TRAIN_BATCH
    batch = train_batch(gen, train_hparams(), b, text_len, mel_len, frames,
                        DEVICE)
    launches = {}

    def add(counts):
        for key, value in counts.items():
            launches[key] = launches.get(key, 0) + value

    runs = {}
    for name, remat in (("plain", False), ("control", False),
                        ("remat", True)):
        hp = train_hparams(remat=remat)
        state = tr.init_fastspeech2_state(hp, device=DEVICE)
        step = tr.make_fastspeech2_train_step(hp, device=DEVICE)
        set_counts({})
        losses, norms, peak = step_peak(state, step, batch, REMAT_STEPS)
        add(read_counts())
        runs[name] = dict(losses=losses, norms=norms, peak=peak,
                          stats={k: v.float().clone() for k, v in
                                 state.model.state_dict().items()
                                 if "running" in k or "num_batches" in k})
        del state, step
        torch.cuda.empty_cache()
    plain, control, remat = runs["plain"], runs["control"], runs["remat"]
    print(f"21(d) remat step, the flagship at B={b} T={mel_len} bf16 "
          f"dropout 0.1, {REMAT_STEPS} steps: losses {remat['losses']}, "
          f"grad norms {remat['norms']}, own peak {remat['peak']:.3f} GB; "
          f"plain {plain['losses']}, {plain['norms']}, {plain['peak']:.3f} "
          f"GB; control {control['losses']}, {control['norms']}")
    check(rel(remat["losses"][0], plain["losses"][0]) <= 1e-6,
          "21(d): the remat step's first loss differs from the plain one's")
    for key in ("losses", "norms"):
        for i in range(REMAT_STEPS):
            tol = max(DDP_OF_CONTROL * rel(control[key][i], plain[key][i]),
                      DDP_FLOOR)
            check(rel(remat[key][i], plain[key][i]) <= tol,
                  f"21(d): remat {key} step {i + 1} "
                  f"{remat[key][i]} against plain {plain[key][i]}")
    check(remat["peak"] < plain["peak"],
          "21(d): the remat step's peak is not below the plain step's")
    worst = 0.0
    for key, value in remat["stats"].items():
        if key.endswith("num_batches_tracked"):
            check(int(value) == REMAT_STEPS, f"21(d): {key} moved "
                                             f"{int(value)} times")
            continue
        ref = plain["stats"][key]
        worst = max(worst, float((value - ref).abs().max())
                    / max(1.0, float(ref.abs().max())))
    print(f"21(d) running statistics after {REMAT_STEPS} remat steps: moved "
          f"{REMAT_STEPS} times; max|d| from the plain steps' {worst:.3g} of "
          f"max(1, max|ref|)")
    check(worst <= REL_TOL[torch.bfloat16],
          "21(d): the remat steps' running statistics differ")

    hp = train_hparams(optimizer="RAdam")
    state = tr.init_fastspeech2_state(hp, device=DEVICE)
    step = tr.make_fastspeech2_train_step(hp, device=DEVICE)
    before = [p.detach().clone() for p in state.optimizer.params]
    set_counts({})
    state, logs = step(state, batch)
    worst = 0.0
    for p, old in zip(state.optimizer.params, before):
        # the first RAdam step is momentum SGD: m / (1 - b1) = g exactly
        want = -hp.learning_rate * p.grad
        room = 2 * torch.finfo(torch.float32).eps * old.abs() + 1e-5 * (
            want.abs())
        worst = max(worst, float(((p.detach() - old - want).abs()
                                  / (room + 1e-30)).max()))
    losses = [float(logs["loss_total"])]
    for _ in range(RADAM_STEPS - 1):
        state, logs = step(state, batch)
        losses.append(float(logs["loss_total"]))
    add(read_counts())
    print(f"21(d) RAdam (lr {hp.learning_rate}): the first step moved "
          f"every weight by -lr x its clipped gradient within "
          f"{worst:.3g} of the rounding room; losses over {RADAM_STEPS} "
          f"steps {losses}")
    check(worst <= 1.0, "21(d): RAdam's first step is not lr x the "
                        "clipped gradient")
    check(all(math.isfinite(x) for x in losses), "21(d): RAdam loss")
    del state, step, before
    torch.cuda.empty_cache()
    return launches


def phase_ddp_wrapper_cost() -> dict:
    """21(b): DDP at world size 1 under NCCL in this process: the DDP
    step's wall and CUDA-event ms beside the plain step's, in turn
    (plain, DDP, DDP, plain, ...), and one profiled step of each for
    their device time, run with the other profiles (the process group
    lives until then: ``end_parallel``). Returns the launches of these
    main paths."""
    import torch.distributed as dist
    from transformer_tts_tpu_torch.parallel import init_distributed
    from transformer_tts_tpu_torch.train import trainer as tr
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    gen = torch.Generator().manual_seed(211)
    b, text_len, mel_len, frames = TRAIN_BATCH
    hp = train_hparams()
    batch = train_batch(gen, hp, b, text_len, mel_len, frames, DEVICE)
    states = {"plain": tr.init_fastspeech2_state(hp, device=DEVICE),
              "ddp": tr.init_fastspeech2_state(hp, device=DEVICE)}
    states["ddp"] = tr.distribute(states["ddp"], DEVICE)
    step = tr.make_fastspeech2_train_step(hp, device=DEVICE)
    for name in states:                 # warm-up
        for _ in range(3):
            states[name], _ = step(states[name], batch)
    torch.cuda.synchronize()
    set_counts({})
    walls = {"plain": [], "ddp": []}
    events = {"plain": [], "ddp": []}
    for name in ["plain", "ddp", "ddp", "plain"] * 5:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        states[name], logs = step(states[name], batch)
        end.record()
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3)
        events[name].append(start.elapsed_time(end))
        check(math.isfinite(float(logs["loss_total"])), "21(b): loss")
    launches = read_counts()
    ms = {name: statistics.median(walls[name]) for name in walls}
    print(f"21(b) DDP at world size 1 ({dist.get_backend()}), the flagship "
          f"B={b} T={mel_len} bf16 dropout 0.1, 10 steps each in turn: "
          f"wall {ms['ddp']:.3f} ms against the plain step's "
          f"{ms['plain']:.3f} ms, CUDA events (the host's gaps included) "
          f"{statistics.median(events['ddp']):.3f} against "
          f"{statistics.median(events['plain']):.3f} ms (medians); the "
          f"device time is in the profiles' phase")
    for name, label in (("plain", "the plain step beside 21(b)'s DDP"),
                        ("ddp", "21(b)'s DDP step at world size 1")):
        PROFILES.append(partial(print_profile, label,
                                partial(step, states[name], batch), 1,
                                ms[name]))
    return launches


def end_parallel():
    """Leave 21(b)'s process group, once its profiles ran."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def phase_parallel(gen) -> dict:
    """Phase 21. Returns the launches of its main paths: (a)'s ranks',
    (b)'s and (d)'s steps."""
    launches = phase_ddp_vs_single(gen)
    for key, value in phase_ddp_wrapper_cost().items():
        launches[key] = launches.get(key, 0) + value
    return launches


def prepare_multihost_cli():
    """21(b)'s training CLI: ``cli/train.py --multihost`` under NCCL at
    world size 1 on the transformer flagship's corpus, run with phase
    5's CLIs; its synthesis CLI reads rank 0's checkpoint."""
    phase_train_cli(torch.Generator().manual_seed(21), "fastspeech2",
                    name="fastspeech2 --multihost",
                    train_flags=["--multihost", "--coordinator",
                                 f"127.0.0.1:{free_port()}",
                                 "--num_processes", "1", "--process_id",
                                 "0"])


# ---- phase 22: the mel-to-mel post-processing line -------------------------

POST_STEPS = (3, 10)              # warm-up and timed steps of each step
POST_VQ_STEPS = (2, 5)            # the residual v3 step with the VQ
POST_SYNTH_CASES = ((1, 768), (8, 2048))
POST_SYNTH_REPS = 10
RTF_LIMIT = 0.01                  # PERF.md section 2
DURATION_BIAS = math.log(1.0 + 6.0)     # ~6 frames per phone


def post_hparams(**overrides):
    """The transformer flagship with a mel-to-mel student (architecture
    mel-mel): v2 with phone_embed, the defaults' 6 layers of FFN kernel 5,
    bf16 amp, dropout 0.1, with overrides."""
    return train_hparams(**dict(dict(architecture="mel-mel", version=2,
                                     phone_embed=True), **overrides))


def integrate_hparams(**overrides):
    """The text-mel-mel flagship: version 8 (a residual and a replace
    student of 6 layers each on the mel_pre) with semantic_mask, bf16
    amp, dropout 0.1, with overrides."""
    return train_hparams(**dict(dict(
        architecture="text-mel-mel", version=8, postnet_pred=False,
        phone_embed=True, semantic_mask=True), **overrides))


def post_teacher(hp):
    """22's frozen FastSpeech 2 (the flagship at ``hp``'s widths, weights
    from seed 22, duration bias for ~6 frames per phone): written as a
    checkpoint with FLAGSHIP's hparams (``serving_dir("post_teacher")``,
    which 22(f)'s engine serves), then built anew and restored from it, as
    cli/train.py restores hp.pretrain_model."""
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    from transformer_tts_tpu_torch.train.checkpoint import load_checkpoint
    net = build_fastspeech2(hp, device="cpu", seed=22)
    with torch.no_grad():
        net.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            DURATION_BIAS)
    path = serving_dir("post_teacher", net)
    teacher = build_fastspeech2(hp, device=DEVICE)
    return load_checkpoint(teacher, path).eval()


def timed_post_steps(label, state, step, batch, want: dict,
                     resident: int, steps=POST_STEPS) -> dict:
    """``steps`` warm-up then timed steps of ``step`` on ``batch``, every
    count set to 0 just before the timed ones: each step must launch
    ``want`` and nothing else, the losses must be finite. Returns ms (the
    median by CUDA events), frames_s (valid mel frames), own_gb (the peak
    over ``resident``, what the card held before the state was built:
    weights, optimizer, teacher, activations), launches, state, logs."""
    warm, n = steps
    for _ in range(warm):
        state, logs = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts({})                          # the main path starts here
    per_step, times, losses = [], [], []
    for _ in range(n):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, batch)
        end.record()
        losses.append(logs["loss_total"])
        per_step.append({k: c - before[k] for k, c in read_counts().items()})
        times.append((start, end))
    torch.cuda.synchronize()
    launches = read_counts()                # it ends here
    own_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    ms = statistics.median(s.elapsed_time(e) for s, e in times)
    frames = int((batch["pos_mel"] > 0).sum())
    losses = torch.stack(losses).float().cpu()
    full = {k: 0 for k in counters()}
    full.update(want)
    print(f"22 {label}: {ms:.3f} ms/step (median of {n}), {frames} valid "
          f"mel frames = {frames / ms * 1e3:.0f} frames/s, own peak "
          f"{own_gb:.3f} GB; launches per step {json.dumps(per_step[0])}; "
          f"losses {[round(x, 4) for x in losses.tolist()]}")
    check(all(c == full for c in per_step),
          f"22 {label}: launches per step {per_step[0]} differ from {want}")
    check(bool(torch.isfinite(losses).all()), f"22 {label}: non-finite loss")
    return dict(ms=ms, frames_s=frames / ms * 1e3, own_gb=own_gb,
                launches=launches, state=state, logs=logs)


def add_launches(total: dict, launches: dict):
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def post_card_vs_cpu(gen, teacher_state: dict):
    """22(a)'s fp32 check: one frozen-teacher student step at dropout 0
    on CPU_STEP_BATCH, on the card (the simple kernels: fp32) and on the
    CPU from the same weights: the losses within 1e-4, each student
    gradient within GRAD_TOL of its own max|g|, the key biases' (0 in
    exact arithmetic) below 1e-5 of the largest. Its launches are put
    back: no main path."""
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    from transformer_tts_tpu_torch.train.post_trainers import (
        init_post_state, make_meltomel_train_step)
    saved = read_counts()
    hp = post_hparams(amp=False, dropout=0.0, dropout_postnet=0.0,
                      dropout_variance_adaptor=0.0)
    b, text_len, mel_len, frames = CPU_STEP_BATCH
    batch = train_batch(gen, hp, b, text_len, mel_len, frames, "cpu")
    runs = {}
    for device in ("cpu", DEVICE):
        teacher = build_fastspeech2(hp, device=device)
        teacher.load_state_dict(teacher_state)
        state = init_post_state(hp, device=device)
        step = make_meltomel_train_step(teacher, hp, device=device)
        set_counts({})
        state, logs = step(state, {k: v.to(device)
                                   for k, v in batch.items()})
        runs[device] = (float(logs["loss_total"]),
                        {n: p.grad.detach().float().cpu()
                         for n, p in state.model.named_parameters()},
                        read_counts())
        del teacher, state, step
    (ref_loss, ref_g, _), (loss, grads, launched) = runs["cpu"], runs[DEVICE]
    # the key biases' gradients cancel to rounding noise on both sides
    noise = max(max(grads[n].abs().max().item(), g.abs().max().item())
                for n, g in ref_g.items() if zero_in_exact_arithmetic(n))
    top = max(g.abs().max().item() for g in ref_g.values())
    rel = {n: (grads[n] - g).abs().max().item()
           / max(g.abs().max().item(), 1e-30) for n, g in ref_g.items()
           if not zero_in_exact_arithmetic(n)}
    worst = max(rel, key=rel.get)
    used = {k: n for k, n in launched.items() if n}
    print(f"22(a) fp32 student step card vs CPU, B={b} T={mel_len}, "
          f"dropout 0: loss {loss:.6f} vs {ref_loss:.6f}; gradients within "
          f"{rel[worst]:.3g} of their own max|g| (tol {GRAD_TOL}; worst "
          f"{worst}); the key biases' noise {noise:.3g} against the top "
          f"max|g| {top:.3g}; card launches (simple kernels) "
          f"{json.dumps(used)}")
    check(noise <= 1e-5 * top, "22(a): a key bias's gradient is not noise")
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
          "22(a): the fp32 student loss differs between card and CPU")
    check(rel[worst] <= GRAD_TOL,
          "22(a): an fp32 student gradient differs between card and CPU")
    check(used and all(k in ("K1", "K2-dq", "K2-dkdv") for k in used),
          f"22(a): the fp32 step took other kernels than the simple "
          f"K1/K2: {used}")
    set_counts(saved)


def phase_post_training(gen, batch) -> tuple:
    """22(a)-(d): the frozen-teacher student step (v2, then a residual v3
    with the VQ), its fp32 card-vs-CPU check, the pregenerated route, the
    integrate step and the conformer student, each at full width on
    ``batch`` (TRAIN_BATCH). Returns (launches summed, the teacher, the
    v2 student's state, the integrate model)."""
    from transformer_tts_tpu_torch.train.post_trainers import (
        init_post_state, make_integrate_train_step,
        make_meltomel_pregen_train_step, make_meltomel_train_step)
    from transformer_tts_tpu_torch.train.trainer import (
        init_fastspeech2_state)
    total = {}
    gc.collect()
    resident = torch.cuda.memory_allocated()
    hp = post_hparams()
    n, n_dec = hp.n_layer_post_model, hp.n_layer_decoder
    shape = f"B={batch['mel'].shape[0]} T={batch['mel'].shape[1]}"
    teacher = post_teacher(hp)
    state = init_post_state(hp, device=DEVICE)
    a = timed_post_steps(
        f"(a) frozen teacher + v2 student step {shape} bf16 dropout 0.1",
        state, make_meltomel_train_step(teacher, hp, device=DEVICE), batch,
        {"K1-90": n_dec, "K1-d-90": n, "K2-90": n}, resident)
    add_launches(total, a["launches"])

    vq_hp = post_hparams(version=3, vq_code=True)
    vq = timed_post_steps(
        "(a) residual v3 student with the VQ", init_post_state(
            vq_hp, device=DEVICE),
        make_meltomel_train_step(teacher, vq_hp, device=DEVICE), batch,
        {"K1-90": n_dec, "K1-d-90": n, "K2-90": n}, resident,
        steps=POST_VQ_STEPS)
    add_launches(total, vq["launches"])
    print(f"22(a) v3 logs: loss_vq {float(vq['logs']['loss_vq']):.5f}, "
          f"codebook moved: "
          f"{bool(vq['state'].model.quantize_lmfb.cluster_size.any())}")
    check(bool(vq["state"].model.quantize_lmfb.cluster_size.any()),
          "22(a): the VQ's EMA did not move")
    del vq
    post_card_vs_cpu(gen, {k: v.cpu() for k, v in
                           teacher.state_dict().items()})

    # (b) the pregenerated corpus: the teacher's output, once
    from transformer_tts_tpu_torch.ops.masks import create_masks
    with torch.no_grad():
        src_mask, mel_mask = create_masks(batch["pos_text"],
                                          batch["pos_mel"])
        t_out = teacher(batch["text"], src_mask, batch["mel"].shape[1],
                        batch["alignment"], batch["f0"], batch["energy"],
                        mel_mask)
    pregen = dict(batch, teacher_mel=t_out.mel_post.float(),
                  teacher_phone=t_out.variance_adaptor_output.float())
    del t_out
    pg_hp = post_hparams(teacher_suffix="_gen")
    b = timed_post_steps(
        "(b) pregenerated v2 student step", init_post_state(
            pg_hp, device=DEVICE),
        make_meltomel_pregen_train_step(pg_hp, device=DEVICE), pregen,
        {"K1-d-90": n, "K2-90": n}, resident)
    add_launches(total, b["launches"])
    print(f"22(b) the pregenerated route: {b['ms']:.3f} ms/step against the "
          f"frozen teacher's {a['ms']:.3f} ms/step "
          f"({a['ms'] / b['ms']:.2f}x)")
    del b, pregen

    # (d) the conformer student
    conf_hp = post_hparams(post_conformer=True)
    d = timed_post_steps(
        "(d) frozen teacher + post_conformer student step",
        init_post_state(conf_hp, device=DEVICE),
        make_meltomel_train_step(teacher, conf_hp, device=DEVICE), batch,
        {"K1-90": n_dec, "K4-d-90": n, "K5-90": n}, resident)
    add_launches(total, d["launches"])
    del d
    torch.cuda.empty_cache()

    # (c) the integrate step
    gc.collect()
    resident = torch.cuda.memory_allocated()
    i_hp = integrate_hparams()
    i_state = init_fastspeech2_state(i_hp, device=DEVICE)
    c = timed_post_steps(
        "(c) text-mel-mel v8 step with semantic_mask", i_state,
        make_integrate_train_step(i_hp, device=DEVICE), batch,
        {"K1-d-90": n_dec + 2 * n, "K2-90": n_dec + 2 * n}, resident)
    add_launches(total, c["launches"])
    print(f"22(c) logs: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in sorted(c["logs"].items())))
    integrate = c["state"].model.eval()
    del c, i_state
    torch.cuda.empty_cache()
    return total, teacher, a["state"].model.eval(), integrate


def phase_post_synthesis(gen, teacher, student, integrate) -> dict:
    """22(e): ``synthesize_integrate`` and ``synthesize_fastspeech2_post``
    at B=1 / 768 and B=8 / 2048 frames (bf16): each call launches K1-90
    once per decoder and student layer and nothing else; ms (median of
    POST_SYNTH_REPS) and RTF, against RTF_LIMIT."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2_post, synthesize_integrate)
    hp = post_hparams()
    n = hp.n_layer_post_model
    with torch.no_grad():
        integrate.variance_adaptor.duration_predictor.linear_layer.bias \
            .fill_(DURATION_BIAS)
    calls = {
        "synthesize_integrate": (
            lambda t, p, mf: synthesize_integrate(integrate, t, p, mf)[::2],
            hp.n_layer_decoder + 2 * n),
        "synthesize_fastspeech2_post": (
            lambda t, p, mf: synthesize_fastspeech2_post(
                teacher, student, t, p, mf, version=hp.version,
                mel_dim_post=hp.mel_dim_post)[:2],
            hp.n_layer_decoder + n)}
    total = {}
    for name, (call, want) in calls.items():
        for b, max_frames in POST_SYNTH_CASES:
            text, pos = text_batch(gen, b, 128, 48, hp.vocab_size)
            text, pos = text.to(DEVICE), pos.to(DEVICE)
            set_counts({})
            mel, mel_len = call(text, pos, max_frames)
            torch.cuda.synchronize()
            launches = read_counts()
            add_launches(total, launches)
            check_only(launches, "K1-90", want,
                       f"22(e) {name} B={b} at {max_frames} frames")
            check(mel.shape == (b, max_frames, hp.mel_dim)
                  and bool(torch.isfinite(mel.float()).all())
                  and int(mel_len.min()) > 0,
                  f"22(e) {name}: mel {tuple(mel.shape)}")
            saved = read_counts()
            ms, (_, mel_len) = wall_ms(lambda: call(text, pos, max_frames),
                                       POST_SYNTH_REPS, warmup=2)
            set_counts(saved)
            audio_s = mel_len.sum().item() * HOP_SECONDS
            print(f"22(e) {name} B={b} L=128 max_frames={max_frames} bf16: "
                  f"{ms:.3f} ms/call (median of {POST_SYNTH_REPS}), "
                  f"{mel_len.sum().item()} frames = {audio_s:.3f} s audio, "
                  f"RTF {ms / 1e3 / audio_s:.6f} (limit {RTF_LIMIT}); "
                  f"{want} K1-90 per call")
    return total


def phase_post_engines(student) -> dict:
    """22(f): the flagship FastSpeech 2 engine with ``post_model=`` (22(a)'s
    v2 student) and the text-mel-mel engine (a fresh integrate flagship),
    B=8 at bucket EXPORT_BUCKET: one ``synthesize`` call each (K1-90 once
    per decoder and student layer), then each exported and its artifact
    run in a fresh process on the engine's inputs, held bit for bit
    against the engine (EXPORT_TOL), its K1-90 counted there."""
    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
    hp = post_hparams()
    teacher_dir = os.path.join(WORK, "serving", "post_teacher")
    student_dir = os.path.join(WORK, "serving", "post_student")
    save_checkpoint(student, student_dir)
    with open(os.path.join(student_dir, "hparams.py"), "w") as fh:
        for key, value in dict(FLAGSHIP, architecture="mel-mel",
                               version=hp.version,
                               phone_embed=True).items():
            fh.write(f"{key} = {value!r}\n")
    i_hp = integrate_hparams()
    net = build_fastspeech2(i_hp, device="cpu", seed=23)
    with torch.no_grad():
        net.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            DURATION_BIAS)
    integrate_dir = serving_dir(
        "post_integrate", net, architecture="text-mel-mel",
        version=i_hp.version, postnet_pred=False, phone_embed=True,
        semantic_mask=True)
    rs = np.random.RandomState(22)
    texts = serve_texts(rs, 8, EXPORT_BUCKET // 2 + 1, EXPORT_BUCKET,
                        hp.vocab_size)
    n = hp.n_layer_post_model
    total, started, wants = {}, [], []
    kw = dict(batch_size=8, frames_per_phone=8,
              text_buckets=(EXPORT_BUCKET,), device=DEVICE)
    for name, engine, want in (
            ("fastspeech2_post", TTSEngine(teacher_dir,
                                           post_model=student_dir, **kw),
             hp.n_layer_decoder + n),
            ("integrate", TTSEngine(integrate_dir, **kw),
             i_hp.n_layer_decoder + 2 * n)):
        results, launches = engine_call_launches(engine, texts)
        add_launches(total, launches)
        check_only(launches, "K1-90", want, f"22(f) the {name} engine")
        check(all(r["mel"].shape[0] > 0 and np.isfinite(r["mel"]).all()
                  for r in results), f"22(f) the {name} engine's mels")
        out_dir = os.path.join(WORK, "export", f"post_{name}")
        t0 = time.perf_counter()
        manifest = engine.export(out_dir)
        seconds = time.perf_counter() - t0
        entry = manifest["buckets"][str(EXPORT_BUCKET)]
        check(entry["file"].startswith(name + "_b8_"),
              f"22(f) {name} manifest {entry}")
        inputs = engine._padded(texts, 8, EXPORT_BUCKET)
        saved = read_counts()
        ms, ref = wall_ms(lambda: engine._run_padded(*inputs), EXPORT_REPS,
                          warmup=1)
        set_counts(saved)
        started.append(start_artifacts([(os.path.join(out_dir,
                                                      entry["file"]),
                                         inputs, EXPORT_REPS)]))
        wants.append((name, want, ms, [x.cpu() for x in ref], seconds))
        del engine
        torch.cuda.empty_cache()
    for proc, (name, want, ms, ref, seconds) in zip(started, wants):
        (got, stats), = finish_artifacts(proc)
        err = max_err(got[0], ref[0])
        same = [torch.equal(g, r.float() if i == 0 else r)
                for i, (g, r) in enumerate(zip(got, ref))]
        print(f"22(f) {name} artifact B=8 bucket {EXPORT_BUCKET}, exported "
              f"in {seconds:.1f} s: a fresh process's call "
              f"{stats['ms']:.3f} ms against the engine's {ms:.3f} ms; mel "
              f"max|d| {err[0]:.3g} of max|ref| {err[1]:.3g}; bit for bit "
              f"(mel, lengths, durations): {same}; launches "
              f"{json.dumps(stats)}")
        check(got[0].shape == ref[0].shape
              and err[0] <= EXPORT_TOL * max(1.0, err[1])
              and all(same[1:]),
              f"22(f): the {name} artifact differs from the engine")
        check(stats["K1-90"] == want and stats["K1"] == 0,
              f"22(f): the {name} artifact's K1-90 launches {stats}")
    return total


POST_CLIS = {}                  # what phase_clis runs for 22(g)


def prepare_post_clis(gen):
    """22(g)'s CLIs, run with the other CLIs (``phase_clis``): in the
    first wave cli/teacher_forcing --save_phone of 4(c)'s transformer
    flagship checkpoint over a synthetic corpus, cli/train mel-mel on that
    checkpoint as the frozen teacher, and cli/train text-mel-mel (a
    TRAIN_CLIS kind: its synthesis CLI in the second wave takes
    --save_prenet); in the second cli/train mel-mel on the corpus that
    teacher_forcing wrote (teacher_suffix) and cli/synthesize
    --post_model with the first mel-mel run's student."""
    hp = train_hparams()
    work = os.path.join(WORK, "post_clis")
    script = write_train_corpus(gen, hp, os.path.join(work, "corpus"))
    test_script = os.path.join(work, "test.txt")
    with open(script) as src, open(test_script, "w") as dst:
        dst.write("".join(src.readlines()[:3]))
    model_dir = os.path.join(WORK, "transformer", "model")

    def hp_file(name, **overrides):
        path = os.path.join(work, f"{name}.py")
        with open(path, "w") as fh:
            for key, value in dict(
                    FLAGSHIP, train_script=script,
                    save_dir=os.path.join(work, name),
                    batch_size=CLI_CORPUS[2], max_epoch=1, save_per_epoch=1,
                    num_workers=CLI_WORKERS, **overrides).items():
                fh.write(f"{key} = {value!r}\n")
        return path

    melmel = dict(architecture="mel-mel", version=2, phone_embed=True)
    cli = "transformer_tts_tpu_torch.cli."
    POST_CLIS.update(
        work=work, script=script, hp=hp,
        first={
            "teacher_forcing --save_phone": [
                cli + "teacher_forcing", "--load_name", model_dir,
                "--hp_file", hp_file("teacher"), "--save_phone",
                "--device", DEVICE],
            "train mel-mel (frozen teacher)": [
                cli + "train", "--hp_file", hp_file(
                    "melmel", pretrain_model=model_dir, **melmel),
                "--max_steps", "3", "--device", DEVICE]},
        second={
            "train mel-mel (teacher_suffix)": [
                cli + "train", "--hp_file", hp_file(
                    "pregen", teacher_suffix="_gen", **melmel),
                "--max_steps", "3", "--device", DEVICE],
            "synthesize --post_model": [
                cli + "synthesize", "--load_name", model_dir,
                "--test_script", test_script, "--save",
                os.path.join(work, "post_out"), "--max_frames", "2048",
                "--device", DEVICE, "--post_model",
                os.path.join(work, "melmel", "epoch_1")]})
    i_hp = integrate_hparams()
    i_file = hp_file("integrate", architecture="text-mel-mel",
                     version=i_hp.version, postnet_pred=False,
                     phone_embed=True, semantic_mask=True)
    TRAIN_CLIS["text-mel-mel"] = dict(
        hp=i_hp, hp_file=i_file, test_script=test_script,
        load_dir=os.path.join(work, "integrate", "epoch_1"),
        out_dir=os.path.join(work, "integrate_out"),
        flags=["--save_prenet"], train_flags=[])


def check_post_clis(outs: dict):
    """What 22(g)'s CLIs wrote: teacher_forcing a mel and phone features
    per utterance, each mel-mel run 3 steps and a student checkpoint,
    --post_model 3 finite mels; and the --save_prenet run's _prenet.npy
    files are its mels."""
    work, script, hp = POST_CLIS["work"], POST_CLIS["script"], POST_CLIS["hp"]
    for name, out in outs.items():
        print(f"22(g) {name}: " + " | ".join(out.strip().splitlines()[-2:]))
    with open(script) as fh:
        names = [ln.split("|")[0] for ln in fh if ln.strip()]
    for path in names:
        n = np.load(path).shape[0]
        mel = np.load(path.replace(".npy", "_gen.npy"))
        phone = np.load(path.replace(".npy", "_gen_phone.npy"))
        check(mel.shape == (n, hp.mel_dim) and mel.dtype == np.float32
              and phone.shape == (n, hp.d_model_encoder)
              and np.isfinite(mel).all(), f"22(g) teacher_forcing {path}")
    for name, sub in (("train mel-mel (frozen teacher)", "melmel"),
                      ("train mel-mel (teacher_suffix)", "pregen")):
        steps = [ln for ln in outs[name].splitlines()
                 if ln.startswith("epoch 1 step")]
        check(len(steps) == 3 and all("skipped_nan=0.0000" in ln
                                      for ln in steps),
              f"22(g) {name}: {steps}")
        check(os.path.exists(os.path.join(work, sub, "epoch_1", "model.pt")),
              f"22(g) {name} saved no student")
    for i in range(3):
        mel = np.load(os.path.join(work, "post_out", f"{i}.npy"))
        check(mel.ndim == 2 and mel.shape[1] == hp.mel_dim
              and mel.shape[0] > 0 and np.isfinite(mel).all(),
              f"22(g) synthesize --post_model mel {i}")
        out = os.path.join(work, "integrate_out")
        check(np.array_equal(np.load(os.path.join(out, f"{i}.npy")),
                             np.load(os.path.join(out, f"{i}_prenet.npy"))),
              f"22(g) synthesize --save_prenet mel {i}")
    print(f"22(g) teacher_forcing wrote {len(names)} mels and phone "
          "features; both mel-mel CLIs took 3 steps and saved a student; "
          "--post_model wrote 3 mels; --save_prenet's mels are its "
          "_prenet.npy files")


def phase_post(gen, batch, smi: str) -> dict:
    """Phase 22, the mel-to-mel post-processing line at full width:
    training (a)-(d), synthesis (e), the engines and their export (f),
    and the checks of its CLIs (g, run in the CLI phase). Returns the
    launches of its main paths, summed."""
    print(smi)
    check_post_clis(POST_CLIS.pop("outs"))
    launches, teacher, student, integrate = phase_post_training(gen, batch)
    add_launches(launches, phase_post_synthesis(gen, teacher, student,
                                                integrate))
    del integrate
    torch.cuda.empty_cache()
    add_launches(launches, phase_post_engines(student))
    del teacher, student
    torch.cuda.empty_cache()
    return launches


# ---- phase 23: tensor parallelism, the meshes, flash_ab --------------------

TP_STEPS = 3
TP_FP32_RTOL = 1e-5             # (a)/(b)'s fp32 step loss (simple kernels)
# the kinds of (a) and (b), and the kernels each one's decoder launches
TP_KINDS = {"fastspeech2": ("K1-d-90", "K2-90"),
            "conformer": ("K4-d-90", "K5-90")}
# (c): the meshes on four ranks (dims, sizes), the flagship at dropout 0
MESH_RUNS = {"data2_model2": ("data", (2, 2)),
             "dcn2_data2": ("dcn", (2, 2, 1))}
# the keep masks drawn on a rank of model = 2: heads [2, 4) of 4
TP_MASK = dict(seed=1234, rate=0.1, heads=4, offset=2, local=2)
# (a)-(c)'s bf16 steps against one process's, after the first step: each
# logged term, the BatchNorm statistics' moves and the share of weight
# updates apart (by UPDATE_APART of the tensor's largest update) within
# DDP_OF_CONTROL x the same-run control's, never held tighter than these
# floors. A split block rounds each rank's bf16 partial product before
# their fp32 sum, where one process rounds the whole product once; Adam
# then carries that round-off into the next steps' terms, which are
# printed, not held. The conformer's grad norm is set by its padded
# rows' LayerNorm gradients (1/sqrt(eps) on exact zeros, PERF.md 7),
# which round-off moves by percents, and its clip then scales the
# gradients to Adam's eps, where the first update reads their size: a
# CPU rehearsal at d 64 in bf16 moved its grad norm 5.6 % at the first
# step and 7.1 % of its updates apart (the transformer's 0.9 %), every
# loss term under 6e-4, and moved its 32 BatchNorm buffers (whose
# smallest moves are nearly 0) up to 4.8 % of their largest moves (6.1 %
# on the card, the transformer's 8 buffers 1.0 %); the fp32 steps of
# (a)/(b) match to 1e-5 (TP_FP32_RTOL).
TP_LOG_FLOOR = 5e-3
TP_CONFORMER_NORM_FLOOR = 0.1
TP_MOVES_FLOOR = {"fastspeech2": 5e-2, "conformer": 0.15}
UPDATE_APART = 0.1
TP_UPDATE_FLOOR = {"fastspeech2": 5e-2, "conformer": 0.15}

TP_RANK = """
import json, sys
import torch
import torch.distributed as dist
import chip_smoke as cs
rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
try:
    settings = json.loads(sys.argv[5])
    cs.FLAGSHIP.update(settings["flagship"])
    cs.DEVICE = settings["device"]
    print(json.dumps(cs.tp_rank(rank, world, work)))
finally:
    dist.destroy_process_group()
"""


def tp_hparams(kind: str, **overrides):
    """The flagship of ``kind`` (bf16 amp, dropout 0.1) with overrides."""
    if kind == "conformer":
        return conformer_hparams(**overrides)
    return train_hparams(**overrides)


def tp_jobs(world: int) -> list:
    """(name, kind, hparams overrides, steps, mesh) of a rank's runs: on
    two ranks (a)'s and (b)'s bf16 steps and their fp32 step, on four
    (c)'s meshes."""
    if world == 2:
        split = ("data", (1, 2))
        return ([(kind, kind, {}, TP_STEPS, split) for kind in TP_KINDS]
                + [(f"{kind} fp32", kind, {"amp": False}, 1, split)
                   for kind in TP_KINDS])
    zero = dict(dropout=0.0, dropout_postnet=0.0,
                dropout_variance_adaptor=0.0)
    return [(name, "fastspeech2", zero, TP_STEPS, mesh)
            for name, mesh in MESH_RUNS.items()]


def tp_mesh(spec):
    from transformer_tts_tpu_torch.parallel import (make_mesh,
                                                    make_multislice_mesh)
    dims, sizes = spec
    if dims == "dcn":
        return make_multislice_mesh(sizes[0], sizes[2], device=DEVICE)
    return make_mesh(*sizes, device=DEVICE)


def busy_ms(ops) -> float:
    """The device's busy ms in ``print_profile``'s operations of one run."""
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in ops) / 1e3


def sync():
    if DEVICE != "cpu":         # a CPU rehearsal's rank process
        torch.cuda.synchronize()


def step_busy_ms(label, step, state, batch, walls) -> float:
    """The profiled device ms of one more step (0 in a CPU rehearsal)."""
    if DEVICE == "cpu":
        return 0.0
    return busy_ms(print_profile(label, partial(step, state, batch), 1,
                                 statistics.median(walls)))


def tp_steps(state, step, batch, n: int, after_first) -> tuple:
    """``n`` steps from launch counts of 0, ``after_first(state)`` called
    after the first: (state, {logs, per_step: each step's nonzero
    launches, walls: each step's host ms, ended by a synchronize,
    launches})."""
    set_counts({})
    logs, per_step, walls = [], [], []
    for i in range(n):
        before = read_counts()
        sync()
        t0 = time.perf_counter()
        state, out = step(state, batch)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: c - before[k] for k, c in read_counts().items()
                         if c != before[k]})
        logs.append({k: float(v) for k, v in out.items()})
        if i == 0:
            after_first(state)
    return state, dict(logs=logs, per_step=per_step, walls=walls,
                       launches=read_counts())


def tp_state(kind, overrides, work):
    from transformer_tts_tpu_torch.train import trainer as tr
    hp = tp_hparams(kind, **overrides)
    state = tr.init_fastspeech2_state(hp, device=DEVICE)
    state.model.load_state_dict(torch.load(os.path.join(work,
                                                        f"init_{kind}.pt")))
    return hp, state, tr.make_fastspeech2_train_step(hp, device=DEVICE)


def tp_rank(rank: int, world: int, work: str) -> dict:
    """A rank of 23(a)-(c), in its own process: each of ``tp_jobs``' runs
    from the saved initial weights, split over the mesh's ``model`` group
    and wrapped in DDP over its data group (``train.trainer.distribute``),
    on its data coordinate's rows of the saved batch. Saves the BatchNorm
    statistics' moves and (rank 0) the gathered weights after the first
    step; returns the logs,
    launches, step walls, the profiled device ms of a bf16 step and the
    multislice hook's counts."""
    from transformer_tts_tpu_torch.parallel import (batch_rows,
                                                    gather_state_dict)
    from transformer_tts_tpu_torch.train import trainer as tr
    batch = torch.load(os.path.join(work, "batch.pt"))
    out = {}
    for name, kind, overrides, n, spec in tp_jobs(world):
        hp, state, step = tp_state(kind, overrides, work)
        init = {k: v.cpu().clone()
                for k, v in state.model.state_dict().items()}
        mesh = tp_mesh(spec)
        state = tr.distribute(state, DEVICE, mesh)
        rows = batch_rows(mesh, batch["text"].shape[0])
        mine = {k: v[rows].to(DEVICE) for k, v in batch.items()}

        def after_first(state, name=name, init=init):
            torch.save(running_moves(state.model, init),
                       os.path.join(work, f"moves {name} {rank}.pt"))
            weights = (gather_state_dict(state.model, state.model_group)
                       if state.model_group is not None
                       else state.model.state_dict())
            if rank == 0:
                torch.save({k: v.float().cpu() for k, v in weights.items()},
                           os.path.join(work, f"weights {name} {world}.pt"))
        state, res = tp_steps(state, step, mine, n, after_first)
        res["rows"] = [rows.start, rows.stop]
        hook = getattr(state.ddp, "comm_state", None)
        if hook is not None:
            res["hook"] = {k: getattr(hook, k) for k in
                           ("buckets", "elements", "dcn_elements")}
        if n == TP_STEPS and world == 2:
            res["busy_ms"] = step_busy_ms(f"23 rank {rank} {name} step",
                                          step, state, mine, res["walls"])
        out[name] = res
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def start_tp_ranks(world: int, work: str) -> list:
    port = str(free_port())
    settings = json.dumps({"flagship": FLAGSHIP, "device": DEVICE})
    return [subprocess.Popen([sys.executable, "-c", TP_RANK, str(r),
                              str(world), port, work, settings], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for r in range(world)]


def tp_single(work: str, world: int) -> dict:
    """One process's runs of ``tp_jobs(world)`` on the whole batch, from
    the same weights with its streams folded as data coordinate 0's:
    each bf16 run twice (the second the same-run control), the fp32 run
    once; each run's statistics' moves and weights after its first step
    kept beside."""
    from transformer_tts_tpu_torch.train import trainer as tr
    batch = {k: v.to(DEVICE) for k, v in
             torch.load(os.path.join(work, "batch.pt")).items()}
    out = {}
    for name, kind, overrides, n, _ in tp_jobs(world):
        runs = []
        for _ in range(2 if n > 1 else 1):
            hp, state, step = tp_state(kind, overrides, work)
            init = {k: v.cpu().clone()
                    for k, v in state.model.state_dict().items()}
            tr.fold_rank(state, 0)
            first = {}

            def after_first(state, init=init, first=first):
                first["moves"] = running_moves(state.model, init)
                first["weights"] = {k: v.float().cpu().clone() for k, v in
                                    state.model.state_dict().items()}
            state, res = tp_steps(state, step, batch, n, after_first)
            res.update(first)
            if n == TP_STEPS and world == 2 and not runs:
                res["busy_ms"] = step_busy_ms(f"23 one process {name} step",
                                              step, state, batch,
                                              res["walls"])
            runs.append(res)
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        out[name] = runs
    return out


def update_share(got: dict, ref: dict, init: dict) -> float:
    """The share of parameter elements whose update (weights minus
    ``init``) differs from ``ref``'s by more than UPDATE_APART of that
    tensor's largest ``ref`` update."""
    apart = total = 0
    for k, w in ref.items():
        if "running" in k or "num_batches" in k:
            continue
        d_ref, d_got = w - init[k].float(), got[k] - init[k].float()
        scale = float(d_ref.abs().max())
        apart += int(((d_got - d_ref).abs() > UPDATE_APART * scale).sum())
        total += w.numel()
    return apart / max(total, 1)


def tp_compare(label: str, name: str, kind: str, ranks: list, single: list,
               world: int, work: str) -> dict:
    """Check one run of the ranks against one process's (and its control)
    after the first step: every logged term, the BatchNorm statistics'
    moves, the weight updates; and the launches of every step; returns
    the ranks' summed launches."""
    ref, control = single
    worst = 0.0
    for i in range(len(ref["logs"])):
        for key, value in sorted(ref["logs"][i].items()):
            ctl = rel(control["logs"][i][key], value)
            floor = (TP_CONFORMER_NORM_FLOOR
                     if kind == "conformer" and key == "grad_norm"
                     else TP_LOG_FLOOR)
            tol = max(DDP_OF_CONTROL * ctl, floor)
            got = max(rel(r[name]["logs"][i][key], value) for r in ranks)
            if i == 0:
                worst = max(worst, got / tol)
            print(f"{label} step {i + 1} {key}: one process {value:.7g}, "
                  f"control {ctl:.3g}; ranks "
                  f"{[round(r[name]['logs'][i][key], 7) for r in ranks]} "
                  f"({got:.3g})"
                  + (f"; allowed {tol:.3g}" if i == 0 else ", not held"))
    check(worst <= 1.0, f"{label}: a logged term differs from one "
                        f"process's past its allowance ({worst:.3g})")
    moves = [torch.load(os.path.join(work, f"moves {name} {r}.pt"))
             for r in range(world)]
    same = all(torch.equal(moves[0][k], m[k]) for m in moves[1:]
               for k in moves[0])
    allowed = max(DDP_OF_CONTROL * moves_off(control["moves"],
                                             ref["moves"]),
                  TP_MOVES_FLOOR[kind])
    off = max(moves_off(m, ref["moves"]) for m in moves)
    print(f"{label} BatchNorm running statistics after the first step "
          f"({len(ref['moves'])} buffers): equal on every rank {same}; "
          f"moves off one process's by {off:.3g} of its largest move, "
          f"allowed {allowed:.3g}")
    check(same and off <= allowed,
          f"{label}: the BatchNorm statistics are not the global batch's")
    init = torch.load(os.path.join(work, f"init_{kind}.pt"))
    gathered = torch.load(os.path.join(work, f"weights {name} {world}.pt"))
    check(sorted(gathered) == sorted(ref["weights"]),
          f"{label}: the gathered state's keys are not the model's")
    ctl_share = update_share(control["weights"], ref["weights"], init)
    share = update_share(gathered, ref["weights"], init)
    allowed = max(DDP_OF_CONTROL * ctl_share, TP_UPDATE_FLOOR[kind])
    print(f"{label} gathered weights after the first step: "
          f"{share:.3g} of the elements' updates apart from one process's "
          f"(control {ctl_share:.3g}, allowed {allowed:.3g})")
    check(share <= allowed, f"{label}: the gathered updates differ from "
                            "one process's")
    summed = {}
    for r, res in enumerate(ranks):
        check(res[name]["per_step"] == ref["per_step"],
              f"{label}: rank {r} launched {res[name]['per_step']} a step, "
              f"one process {ref['per_step']}")
        add_launches(summed, {k: v for k, v in res[name]["launches"].items()
                              if v})
    print(f"{label} launches a step on each rank "
          f"{ranks[0][name]['per_step'][0]} = one process's")
    return summed


def tp_keep_bits(relative: bool, backward: bool, head_offset: int,
                 b: int, t: int) -> torch.Tensor:
    """(b, 2, t, t) bool keep bits that K1-d-90 (``backward``: K2-90's dv;
    ``relative``: K4-d-90, K5-90's dv) draws on a tensor of 2 heads at
    ``head_offset`` of TP_MASK["heads"]: with q = k (= p) = 0 every
    probability is 1/t, so a one-hot v (or dO) over a window of 96 keys
    (query rows) puts each keep bit in its own output element, nonzero
    iff kept."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    d, h = 96, TP_MASK["local"]
    z = torch.zeros(b, h, t, d, device=DEVICE, dtype=torch.bfloat16)
    p = torch.zeros(h, t, d, device=DEVICE, dtype=torch.bfloat16)
    k_len = torch.full((b,), t, dtype=torch.int32, device=DEVICE)
    kw = dict(dropout_rate=TP_MASK["rate"], dropout_seed=TP_MASK["seed"],
              head_offset=head_offset, heads_total=TP_MASK["heads"])

    def fwd(v):
        if relative:
            return fr.flash_relpos_attention(z, z, z, v, p, k_len, **kw)
        return fa.flash_attention(z, z, v, k_len, **kw)

    bits = torch.empty(b, h, t, t, dtype=torch.bool, device=DEVICE)
    o, lse = fwd(z)
    for j in range(0, t, d):
        w = min(d, t - j)
        onehot = torch.zeros_like(z)
        onehot[:, :, j:j + w, :w] = torch.eye(w, device=DEVICE,
                                              dtype=z.dtype)
        if not backward:
            bits[..., j:j + w] = fwd(onehot)[0][..., :w] != 0
            continue
        delta = fa.bwd_delta(o, onehot)
        if relative:
            dv = fr.flash_relpos_attention_bwd_sm90(
                z, z, z, z, p, onehot, lse, delta, k_len, sm_scale=d ** -0.5,
                **kw)[3]
        else:
            dv = fa.flash_attention_bwd_sm90(
                z, z, z, onehot, lse, delta, k_len, sm_scale=d ** -0.5,
                **kw)[2]
        bits[:, :, j:j + w, :] = (dv[..., :w] != 0).transpose(-1, -2)
    return bits


def tp_kernel_checks(gen, k_len):
    """23(a)/(b)'s kernel checks at a rank's shapes, (16, 2, 1024, 96) bf16
    with head offset 2 of 4 (launches kept off the main path's counts):
    each kernel's keep bits bit for bit the whole-head mask's slice, and
    a planted fault (head offset 0 on heads [2, 4)) caught; each kernel
    against its plain version on random inputs with the batch's k_len."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    saved = read_counts()
    b, t = TRAIN_BATCH[0], TRAIN_BATCH[2]
    off, local, heads = TP_MASK["offset"], TP_MASK["local"], TP_MASK["heads"]
    whole = fa._full_keep_mask(b, heads, t, t, TP_MASK["seed"],
                               TP_MASK["rate"], DEVICE)
    want = whole[:, off:off + local] != 0
    del whole
    for (relative, backward), kid in (((False, False), "K1-d-90"),
                                      ((False, True), "K2-90"),
                                      ((True, False), "K4-d-90"),
                                      ((True, True), "K5-90")):
        got = tp_keep_bits(relative, backward, off, b, t)
        fault = tp_keep_bits(relative, backward, 0, b, t)
        apart = float((fault != want).float().mean())
        print(f"23 {kid} keep bits at ({b}, {local}, {t}, 96) bf16, heads "
              f"[{off}, {off + local}) of {heads}: equal to the whole-head "
              f"mask's slice {bool(torch.equal(got, want))} (kept "
              f"{float(got.float().mean()):.4f}); the planted fault (head "
              f"offset 0) differs in {apart:.4f} of the bits: "
              f"{'caught' if apart > 0 else 'NOT caught'}")
        check(torch.equal(got, want), f"23: {kid}'s keep mask at a head "
                                      "offset is not the whole mask's slice")
        check(apart > 0, f"23: {kid}'s mask check misses the planted fault")
    g = torch.Generator().manual_seed(23)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(DEVICE, torch.bfloat16)
    kl = k_len.to(DEVICE, torch.int32)
    kw = dict(dropout_rate=TP_MASK["rate"], dropout_seed=TP_MASK["seed"],
              head_offset=off, heads_total=heads)
    scale = 96 ** -0.5
    for relative in (False, True):
        names = ("q_u", "q_v", "k", "v") if relative else ("q", "k", "v")
        xs = [rnd(b, local, t, 96) for _ in names]
        if relative:
            xs.append(rnd(local, t, 96))
        do = rnd(b, local, t, 96)
        leaves = [x.clone().requires_grad_() for x in xs]
        fn = fr.flash_relpos_attention if relative else fa.flash_attention
        o, lse = fn(*leaves, kl, **kw)
        grads = torch.autograd.grad(o, leaves, do)
        o = o.detach()
        if relative:
            ref_o, _ = fr.flash_relpos_attention_fwd_reference(
                *xs, kl, scale, TP_MASK["rate"], TP_MASK["seed"], off, heads)
            ref_g = fr.flash_relpos_attention_bwd_reference(
                *xs, ref_o, lse, do, kl, scale, TP_MASK["rate"],
                TP_MASK["seed"], off, heads)
            ids, gnames = ("K4-d-90", "K5-90"), ("dq_u", "dq_v", "dk", "dv",
                                                  "dp")
        else:
            ref_o, _ = fa.flash_attention_fwd_reference(
                *xs, kl, scale, TP_MASK["rate"], TP_MASK["seed"], False,
                None, off, heads)
            ref_g = fa.flash_attention_bwd_reference(
                *xs, ref_o, lse, do, kl, scale, TP_MASK["rate"],
                TP_MASK["seed"], False, None, off, heads)
            ids, gnames = ("K1-d-90", "K2-90"), ("dq", "dk", "dv")
        errs = {"o": float((o.float() - ref_o.float()).abs().max()) / max(
            float(ref_o.float().abs().max()), 1e-30)}
        for n, got, want in zip(gnames, grads, ref_g):
            errs[n] = float((got.float() - want.float()).abs().max()) / max(
                float(want.float().abs().max()), 1e-30)
        errs = {k: float(v) for k, v in errs.items()}
        print(f"23 {ids[0]} and {ids[1]} at heads [{off}, {off + local}) of "
              f"{heads} against their plain versions, rate "
              f"{TP_MASK['rate']}: max abs err over max|ref| "
              + json.dumps({k: round(v, 5) for k, v in errs.items()})
              + f"; allowed {TOLS[torch.bfloat16][0]}")
        check(max(errs.values()) <= TOLS[torch.bfloat16][0],
              f"23: {ids} at a head offset differ from their plain versions")
    set_counts(saved)


def phase_tp(gen, smi: str) -> dict:
    """Phase 23: (a) the transformer flagship and (b) the conformer
    flagship on two gloo ranks of model = 2 at full width, each against
    one process on the same weights and batch; (c) the (data 2, model 2)
    and (dcn 2, data 2) meshes on four gloo ranks; (d) flash_ab's fwd,
    bwd and drop modes. Returns the launches of the ranks' main paths."""
    from transformer_tts_tpu_torch.cli import flash_ab
    from transformer_tts_tpu_torch.train import trainer as tr
    print(smi)
    work = os.path.join(WORK, "tp")
    os.makedirs(work, exist_ok=True)
    b, text_len, mel_len, frames = TRAIN_BATCH
    batch = train_batch(gen, train_hparams(), b, text_len, mel_len, frames,
                        "cpu")
    torch.save(batch, os.path.join(work, "batch.pt"))
    for kind in TP_KINDS:
        state = tr.init_fastspeech2_state(tp_hparams(kind), device=DEVICE)
        torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                   os.path.join(work, f"init_{kind}.pt"))
        del state
    tp_kernel_checks(gen, (batch["pos_mel"] > 0).sum(1))
    launches = {}
    for world, label in ((2, "23(a)/(b)"), (4, "23(c)")):
        single = tp_single(work, world)
        t0 = time.perf_counter()
        ranks = finish_ranks(start_tp_ranks(world, work))
        print(f"{label}: {world} gloo ranks on one card, "
              f"{time.perf_counter() - t0:.1f} s with their start")
        for name, kind, overrides, n, spec in tp_jobs(world):
            tag = {"fastspeech2": "23(a)", "conformer": "23(b)"}.get(
                kind if world == 2 else None, "23(c)")
            tag = f"{tag} {name} on {spec[0]} {spec[1]}"
            if n == 1:              # the fp32 step, the simple kernels
                ref = single[name][0]["logs"][0]
                for key in ("loss_total", "grad_norm"):
                    got = [r[name]["logs"][0][key] for r in ranks]
                    print(f"{tag} {key}: one process {ref[key]:.8g}, ranks "
                          f"{got}, rel "
                          f"{max(rel(x, ref[key]) for x in got):.3g}")
                check(max(rel(r[name]["logs"][0]["loss_total"],
                              ref["loss_total"]) for r in ranks)
                      <= TP_FP32_RTOL, f"{tag}: the loss is off one "
                                       f"process's past {TP_FP32_RTOL}")
                continue
            add_launches(launches, tp_compare(tag, name, kind, ranks,
                                              single[name], world, work))
            if world == 2:
                one = single[name][0]
                walls = [round(statistics.median(r[name]["walls"]), 3)
                         for r in ranks]
                busy = [round(r[name]["busy_ms"], 3) for r in ranks]
                print(f"{tag} step times (the two ranks share the card): "
                      f"wall ms per rank {walls}, profiled device ms per "
                      f"rank {busy}; one process wall "
                      f"{statistics.median(one['walls']):.3f} ms, device "
                      f"{one['busy_ms']:.3f} ms")
                for r, res in enumerate(ranks):
                    for kid in TP_KINDS[kind]:
                        check(res[name]["per_step"][0].get(kid) ==
                              train_hparams().n_layer_decoder,
                              f"{tag}: rank {r} launched "
                              f"{res[name]['per_step'][0]}")
            else:
                print(f"{tag}: rows per rank "
                      f"{[r[name]['rows'] for r in ranks]}")
            if spec[0] == "dcn":
                hook = ranks[0][name]["hook"]
                print(f"{tag} the DDP hook: {hook['buckets']} buckets, "
                      f"{hook['elements']} gradient elements, "
                      f"{hook['dcn_elements']} across the slices "
                      f"({hook['dcn_elements'] / hook['elements']:.4f})")
                check(0 <= 2 * hook["dcn_elements"] - hook["elements"]
                      <= hook["buckets"],
                      f"{tag}: the dcn all-reduce did not carry half the "
                      "gradient")
        del single
        torch.cuda.empty_cache()
    saved = read_counts()
    print(f"23(d) flash_ab at (32, {flash_ab.HEADS}, 1024, "
          f"{flash_ab.HEAD_DIM}) bf16, device ms (CUDA events), {smi}:")
    flash_ab.main(["fwd", "bwd", "drop", "1024", "--device", DEVICE])
    set_counts(saved)
    return launches


def worst_err(errs: dict, peaks: dict, names) -> dict:
    """The error of the entry's worst output among ``names``, the one
    with the largest err / max|ref|: its max abs error, its own max|ref|
    and its name (``worst``), so the pair describes one tensor."""
    def share(n):
        if peaks[n]:
            return errs[n] / peaks[n]
        return float("inf") if errs[n] else 0.0
    n = max(names, key=share)
    return {"max_abs_err": errs[n], "max_abs_ref": peaks[n], "worst": n}


def of_tensor(res: dict) -> str:
    return f", of {res['worst']}" if "worst" in res else ""


def kernels_line_entry(name, source, replaces, launches, res) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]}


PHASE_TIMES = []


def print_resident(label: str, n: int = 8):
    """The ``n`` largest card storages that Python objects hold at
    ``label``, and what all of them sum to."""
    storages = {}
    for obj in gc.get_objects():
        try:
            if not (torch.is_tensor(obj) and obj.is_cuda):
                continue
            storage = obj.untyped_storage()
        except Exception:       # objects that fail the type test
            continue
        storages[storage.data_ptr()] = (storage.nbytes(), tuple(obj.shape),
                                        str(obj.dtype)[6:])
    top = sorted(storages.values(), reverse=True)[:n]
    print(f"resident {label}: {torch.cuda.memory_allocated() / 1e9:.3f} GB; "
          f"{len(storages)} storages held from Python sum "
          f"{sum(v[0] for v in storages.values()) / 1e9:.3f} GB; largest "
          + ", ".join(f"{nb / 1e6:.1f} MB {shape} {dtype}"
                      for nb, shape, dtype in top))


@contextmanager
def phase(name: str):
    """Print the wall time of the phase ``name`` once it ends, and the card
    memory live tensors hold then, before and after a garbage collection
    frees what the phase left in reference cycles."""
    t0 = time.perf_counter()
    yield
    PHASE_TIMES.append((name, time.perf_counter() - t0))
    held = torch.cuda.memory_allocated()
    gc.collect()
    print(f"[phase {name}: {PHASE_TIMES[-1][1]:.1f} s; resident after "
          f"{held / 1e9:.3f} GB, {torch.cuda.memory_allocated() / 1e9:.3f} "
          f"GB after gc]", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    from transformer_tts_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    registry = kernels()
    names = sorted({entry[2] for entry in registry.values()}
                   | {"flash_attention_bwd", "flash_relpos_bwd",
                      "flash_bwd_sm90", "flash_relpos_bwd_sm90"})
    with phase("build"):
        cuda_build.build(names)
    print("build seconds (all started together): " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in cuda_build.BUILD_SECONDS.items()))
    for name in names:
        for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "wgmma" in line:
                print(f"  ptxas {name}:", line.strip())

    gen = torch.Generator().manual_seed(0)
    b, text_len, mel_len, frames = TRAIN_BATCH
    batch = train_batch(gen, train_hparams(), b, text_len, mel_len, frames,
                        DEVICE)
    ar_hp = ar_hparams()
    ar_batch = ar_train_batch(gen, ar_hp, b, text_len, mel_len, frames,
                              DEVICE)
    r = ar_hp.reduction_rate
    ar_groups = (ar_batch["pos_mel"][:, :-r:r] > 0).sum(1)
    with phase("kernels vs plain"):
        phase_kernel_vs_plain(gen)
        phase_train_kernels_vs_plain(gen, (batch["pos_mel"] > 0).sum(1))
    with phase("K3 vs plain"):
        phase_causal_kernels_vs_plain(gen, ar_groups)
    with phase("K4 and K5 vs plain"):
        phase_relpos_kernels_vs_plain(gen, (batch["pos_mel"] > 0).sum(1))
    with phase("K6 vs plain"):
        phase_bias_kernels_vs_plain(gen)
    main_runs = {}
    for name, (stacks, kid) in PATHS.items():
        with phase(f"{name} synthesis"):
            phase_teacher_forced(gen, name, stacks)
            hp, model, launches, main_inputs = phase_synthesis(
                gen, name, stacks, kid)
            phase_cli(name, stacks, hp, model)
            main_runs[kid] = (launches, main_inputs)
            del model
            torch.cuda.empty_cache()
    with phase("fastspeech2 training"):
        phase_card_vs_cpu(gen, "fastspeech2")
        train_launches, fwd_inputs, bwd_inputs = phase_train_step(
            batch, "fastspeech2")
        phase_train_cli(gen, "fastspeech2")
    with phase("conformer training"):
        phase_card_vs_cpu(gen, "conformer")
        conf_launches, conf_fwd_inputs, conf_bwd_inputs = phase_train_step(
            batch, "conformer")
        phase_train_cli(gen, "conformer")
    with phase("AR eval forward and decode"):
        k3f_launches, k3f_inputs = phase_ar_teacher_forced(gen)
        phase_ar_decode_vs_forward(gen)
    with phase("AR synthesis"):
        phase_ar_synthesis(gen)
    print_resident("before phase 6")
    with phase("AR training"):
        phase_card_vs_cpu(gen, "ar")
        ar_launches, ar_fwd_inputs, ar_bwd_inputs = phase_train_step(
            ar_batch, "ar")
        phase_train_cli(gen, "ar")
    with phase("features"):
        corpus_stats = phase_features(gen)
    with phase("vocoder forward"):
        phase_vocoder_forward(gen)
    with phase("vocoded synthesis"):
        phase_vocoded_synthesis(gen, *corpus_stats)
    with phase("vocoder training"):
        phase_vocoder_step(gen)
    vocoder_clis = prepare_vocoder_clis(gen)
    print_resident("before phases 15-16")
    # phases 15 and 17-19 at LATER_DEPTH, for the run's time
    full_depth = dict(FLAGSHIP)
    FLAGSHIP.update(LATER_DEPTH)
    new_gen = torch.Generator().manual_seed(15)     # phases 15-16's data
    with phase("GST AR"):
        phase_ar_teacher_forced(new_gen, gst=True)
        phase_gst_synthesis(new_gen)
        phase_card_vs_cpu(new_gen, "gst")
        phase_train_step(ar_batch, "gst")
        phase_train_cli(new_gen, "gst")
    FLAGSHIP.clear()
    FLAGSHIP.update(full_depth)
    sq_clis = prepare_sq_clis(new_gen)
    phase_train_cli(torch.Generator().manual_seed(19), "tacotron2")
    prepare_multihost_cli()
    prepare_post_clis(torch.Generator().manual_seed(22))
    with phase("CLIs of 4, 5, 6, 14, 15, 16, 19, 21 and 22"):
        sq_outs = phase_clis(sq_clis, vocoder_clis)
    with phase("SQ-VAE FastSpeech 2"):
        average_synthesis = phase_sq_clis(sq_clis, sq_outs)
        try:
            phase_sq_forward(new_gen)
            _, model, _, _ = phase_synthesis(new_gen, "sq", SQ_STACKS,
                                             "K1-90")
            del model
            torch.cuda.empty_cache()
            with fixed_gumbel(new_gen):
                phase_card_vs_cpu(new_gen, "sq")
            phase_train_step(batch, "sq")
            finish_sq_clis(average_synthesis)
        finally:
            if average_synthesis["proc"].poll() is None:
                average_synthesis["proc"].kill()
                average_synthesis["proc"].wait()
    FLAGSHIP.update(LATER_DEPTH)
    with phase("serving"):
        engine_launches = phase_serving(new_gen, smi)
    with phase("conditioning"):
        cond_launches = phase_conditioning(smi)
    print("phase 18 launches, each main path counted from 0, summed: "
          + json.dumps(cond_launches))
    with phase("other families"):
        other_launches = phase_other_families(smi)
    print("phase 19 launches, each main path counted from 0, summed: "
          + json.dumps(other_launches))
    for kid, n in other_launches.items():
        cond_launches[kid] = cond_launches.get(kid, 0) + n
    FLAGSHIP.clear()
    FLAGSHIP.update(full_depth)
    with phase("export"):
        phase_export(torch.Generator().manual_seed(20), smi)
    with phase("data and sequence parallelism, RAdam, remat"):
        parallel_launches = phase_parallel(torch.Generator().manual_seed(21))
    print("phase 21 launches, each main path counted from 0, summed: "
          + json.dumps(parallel_launches))
    for kid, n in parallel_launches.items():
        cond_launches[kid] = cond_launches.get(kid, 0) + n
    with phase("mel-to-mel post-processing"):
        post_launches = phase_post(torch.Generator().manual_seed(22), batch,
                                   smi)
    print("phase 22 launches, each main path counted from 0, summed: "
          + json.dumps(post_launches))
    add_launches(cond_launches, post_launches)
    with phase("tensor parallelism and the meshes"):
        tp_launches = phase_tp(torch.Generator().manual_seed(23), smi)
    print("phase 23 launches, each main path counted from 0, summed: "
          + json.dumps(tp_launches))
    add_launches(cond_launches, tp_launches)

    lines = []
    with phase("kernels at their main paths' inputs"):
        for path_kid, (launches, main_inputs) in main_runs.items():
            tensors, k_len = list(main_inputs[:-1]), main_inputs[-1]
            # the transformer's path runs K1-90, the conformer's K4-90; the
            # simple K1 and K4 are timed on the same input for the A/B
            simple = path_kid[:-len("-90")]
            ab = {}
            for kid in (path_kid, simple):
                res = ab[kid] = kernel_timings(kid, tensors, k_len)
                print(f"{kid} at the main path's input "
                      f"{tuple(tensors[0].shape)} "
                      f"{str(tensors[0].dtype)[6:]}, k_len "
                      f"{k_len.tolist()}: kernel {res['ms']:.4f} ms, plain "
                      f"{res['plain_ms']:.4f} ms, library "
                      f"{res['library_ms']:.4f} ms, bound "
                      f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
                      f"max|dO| {res['max_abs_err']:.3g}, launches "
                      f"{launches[kid]}")
                if "bias_ms" in res:
                    print(f"{kid} library yardstick leaves out building its "
                          f"bias: {res['bias_ms']:.4f} ms")
                _, _, name, source, replaces, _ = registry[kid]
                lines.append(kernels_line_entry(
                    name, source, replaces,
                    launches[kid] + cond_launches.get(kid, 0), res))
            print(f"A/B at the B=8 synthesis call's first decoder "
                  f"layer: {path_kid} {ab[path_kid]['ms']:.4f} ms against "
                  f"the simple {simple} {ab[simple]['ms']:.4f} ms "
                  f"({ab[simple]['ms'] / ab[path_kid]['ms']:.2f}x), SDPA "
                  f"{ab[path_kid]['library_ms']:.4f} ms")
        runs = {}                 # id -> (result, launches, its input)
        for kid, res in train_kernel_timings(fwd_inputs,
                                             bwd_inputs).items():
            runs[kid] = (res, train_launches[kid], fwd_inputs)
        for kid, res in train_kernel_timings(ar_fwd_inputs, ar_bwd_inputs,
                                             causal=True).items():
            runs[kid] = (res, ar_launches[kid], ar_fwd_inputs)
        for kid, res in causal_forward_timings(k3f_inputs).items():
            runs[kid] = (res, k3f_launches[kid], k3f_inputs)
        for kid, res in relpos_train_kernel_timings(
                conf_fwd_inputs, conf_bwd_inputs).items():
            runs[kid] = (res, conf_launches[kid], conf_fwd_inputs)
        for kid, (_, _, name, source, replaces) in train_kernels().items():
            res, launches, (args, kw) = runs[kid]
            q, k_len = args[0], args[-1]
            print(f"{kid} at its path's input {tuple(q.shape)} "
                  f"{str(q.dtype)[6:]} rate {kw.get('dropout_rate', 0.0)}, "
                  f"k_len {k_len.tolist()}: kernel {res['ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, library "
                  f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
                  f"ms ({res['bound_by']}), max abs err "
                  f"{res['max_abs_err']:.3g} (max|ref| "
                  f"{res['max_abs_ref']:.3g}{of_tensor(res)}), launches "
                  f"{launches}")
            lines.append(kernels_line_entry(
                name, source, replaces,
                launches + cond_launches.get(kid, 0), res))
        bias_res, bias_launches = bias_kernel_timings(conf_fwd_inputs,
                                                      conf_bwd_inputs)
        q, k_len = conf_fwd_inputs[0][0], conf_fwd_inputs[0][-1]
        for kid, (_, _, name, source, replaces) in bias_kernels().items():
            res = bias_res[kid]
            print(f"{kid} at the conformer step's input {tuple(q.shape)} "
                  f"{str(q.dtype)[6:]}, k_len {k_len.tolist()}: kernel "
                  f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
                  f"library {res['library_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}), max abs "
                  f"err {res['max_abs_err']:.3g} (max|ref| "
                  f"{res['max_abs_ref']:.3g}{of_tensor(res)}), launches in "
                  f"the route A/B "
                  f"{bias_launches[kid]}")
            lines.append(kernels_line_entry(name, source, replaces,
                                            bias_launches[kid], res))
    with phase("attention paths"):
        phase_attention_paths(gen)
    with phase("profiles"):
        seconds = []
        while PROFILES:
            t0 = time.perf_counter()
            PROFILES.pop(0)()           # each frees what it held once run
            seconds.append(time.perf_counter() - t0)
        print("profile wall times (s): " + ", ".join(
            f"{sec:.1f}" for sec in seconds))
        end_parallel()

    print("phase wall times: " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in PHASE_TIMES)
        + f"; total {time.perf_counter() - t_start:.1f} s")
    print("engine launches (phase 17, each call counted from 0): "
          + json.dumps(engine_launches))
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
