"""Smoke run of the PyTorch + CUDA port (``rwkvtts_torch``) on one NVIDIA GPU.

It builds the port's hand-written CUDA kernels from ``rwkvtts_torch/csrc``,
holds each against its plain PyTorch version on the card, checks a small
generation, a small train step and a small stream against the plain path
on the CPU, then drives the four main paths once: Spark speech-LM batched
generation at 1024 hidden x 24 layers (random weights from a seed), B = 64,
a 128-token prompt and 256 new tokens at top-k 50 / top-p 0.95, the
configuration of ``bench.py``; Spark training at 1024 x 24 through the
train CLI, B = 8 x 2048 tokens of synthetic rows, bf16 over f32 master
weights, per-block remat, the fused-prep WKV7 kernel pair; CosyVoice
streaming TTS at the deployed 1.5B pairing (RWKV-7 2048 x 24 LM, B = 1
decode, CosyVoice2 flow + HiFT), the configuration of
``benchmarks/bench_streaming_latency.py``; and the Spark continuous-batching
server through its launcher at 1024 x 24 with the launcher's defaults (96
slots, 32-step chunks, the in-place WKV step), the traffic of
``benchmarks/bench_serving_continuous.py``; then the Spark text->wav route
on it: BiCodec at the published Spark-TTS-0.5B widths and the
wav2vec2-large-xlsr-53 frontend's shape (random weights from a seed),
``SparkPipeline.synthesize`` / ``design_voice`` and the server's answers
with audio; then CosyVoice zero-shot from a prompt wav at the 1.5B pairing
with the S3 tokenizer and CAM++ at their published widths
(``CosyPipeline.synthesize`` on both decode routes, cross-lingual,
instruct, voice conversion), and Cosy B=64 offline generation at 2048 x
24, the configuration of ``benchmarks/bench_generate_mega_ab.py --family
cosy --hidden 2048``; then the CosyVoice server at the 1.5B pairing through
``launch.build_cosy_pipeline`` and ``CosyTTSService`` (one shared slot
pool, the streaming endpoint, stored voices, mp3, the SFM levers), the
traffic of ``benchmarks/bench_pooled_streaming.py``'s defaults; then XY/Higgs
text->wav: the 8-channel XY LM at 1024 x 24 through ``xy_generate`` on
both backbone routes (``benchmarks/bench_families_scale.py``'s XY cell),
``XYPipeline.synthesize`` with XY_Tokenizer at its published widths, and
the Higgs codec; then the ASR, S2S and two-tower families:
``asr.transcribe`` with the whisper-large-v3 encoder into a 1024 x 24 LLM,
``s2s.generate`` and ``tts_two_tower.generate`` at 1024 x 24
(``benchmarks/bench_families_scale.py``'s cells); then every training task of
the train CLI at its family's width (Spark with properties and global
tokens, Cosy at 2048, XY, ASR with the whisper-large-v3 encoder frozen,
S2S, two-tower, the SFM flow, Spark 1.4B with adafactor); then long-form
text and the seed-tts eval: ``CosyPipeline.synthesize_long`` at the 1.5B
pairing, the phoneme-marked Spark training through the train CLI, the
seed-tts harness (``generate_testset``, ``evaluate_wer`` on the ASR model
at asr-0.4B's widths, ``evaluate_sim`` on CAM++), the WER ranking demo, and
greedy Spark generation at 1024 x 24; then training from raw audio: a seeded
corpus written as webdataset tars and streamed back through the C++ tar
streamer, the offline token extractors on BiCodec, XY_Tokenizer, Higgs, S3
and CAM++ at their published widths, Spark 1024 x 24 trained from the tars
through the train CLI with BiCodec tokenizing inline (``--data-format
webdataset --codec-dir``), and the trained model exported as one
flat-vocabulary BlinkDL model; then quantized decode: int8 / int4 decode
weights and the sampler's bf16 ranking against the CPU, the CosyVoice
server at the 1.5B pairing with int8 and with int4 decode weights, the
quality probe of the quantized modes (rwkvtts_torch.eval.quant_quality)
and the non-causal flow estimator; phase 10 also trains under the remat
policies, phase 16 serves one request through ``launch --int4``, and phase
18 drives the interactive console.

Phases, each printing its own lines; any failure raises, so the run exits
non-zero and prints no result:

  1. device  the card's name and power limit (nvidia-smi); no CUDA device is an error
  2. build   nvcc of rwkvtts_torch/csrc/*.cu into a ctypes library; ptxas's
             registers and spills (a spill in a chunked WKV7 kernel fails)
  3. wkv7    the chunked forward kernel's launch plan against the library;
             the kernel vs ops/wkv7.wkv7_scan (f32 reference) with and
             without state and resets, at the Cosy prefill, the Spark
             server's admission bucket and the Cosy server's largest
             admission (8, 256, 32), and at every w_raw = -0.5 in f32; two calls
             bit-identical (anchors included); ms, device ms and bound at
             the shapes of the paths that run it
  4. decode  the B=64 decode step's launch plan (shared memory a CTA, the
             workspace); the step vs decode_step_plain at 2048 x 2 (2 chained
             steps) and at 1024 x 24 (4 steps); two calls on the same inputs
             bit-identical; 8 L + 2 launches a step; ms a step with and
             without programmatic dependent launch, device time by kernel
             (torch.profiler) and the busy share
  5. small   greedy generation at hidden 256 x 2 layers: kernels on the card
             vs plain versions on the CPU
  6. main    the full-size generation, launch counts, audio tok/s
  7. wkv7 train  the chunked backward's launch plan against the library;
             autograd through WKV7 (wkv7_fwd + wkv7_bwd kernels) vs
             autograd through wkv7_scan: outputs and every gradient, also at
             every w_raw = -0.5 in f32 (gated); two calls bit-identical;
             forward and backward ms
  8. wkv7 fused  the same for WKV7Fused (the chunked pair) vs
             wkv7_fused_plain, the five per-head gradients included, and
             every w_raw at -0.5 in f32 (gated); its launch plan against the
             library; two calls bit-identical; saving, primal and backward ms;
             kernels 3-5 on fixed inputs give the recorded bits
  9. train small one train step of a hidden 256 x 2 layer Spark on the card
             vs the same step on the CPU's plain path: loss and grad norm
 10. train main  Spark 1024 x 24 training through rwkvtts_torch.train.cli:
             finite losses near ln 8193, launch counts, ms a step, tokens/s,
             peak memory; its first rows, 1 + 3 steps, under the default
             full replay, --remat-policy wkv (kernels 4 / 5 24 / 24 a step)
             and dots (48 / 24), each first loss = the default's, ms a
             step, peak memory; the WKV kernels' share of device time
             (torch.profiler); then the unfused path at fewer layers
 11. decode b1  the B=1 step's launch plan (shared memory a CTA, the
             workspace) against the library; the step (the Cosy LM step) vs
             decode_step_plain at 2048 x 24, bf16 and f32 WKV carry, 4
             chained steps; two calls bit-identical; the launches a step;
             ms a step with and without programmatic dependent launch,
             device time by kernel, each GEMV's GB/s, the bound from the
             packed bytes
 12. cosy small greedy streaming at LM 256 x 2 bf16 with a tiny flow / HiFT:
             kernels on the card vs plain versions on the CPU, same tokens
 13. cosy main  the Cosy streaming path at the 1.5B pairing (RWKV-7 2048 x
             24 + CosyVoice2 flow + HiFT defaults, StreamConfig defaults):
             3 utterances of 200 characters, 75 prompt tokens, 400 new
             tokens (1 warm-up, 2 timed): TTFA, RTF, LM ms a token, flow and
             HiFT ms a hop, decode launches a token, peak memory
 14. wkv7 step  the slot pools' in-place WKV step kernel vs wkv7_step_plain
             at the Spark pool's B = 96, H = 16 and the Cosy pool's B = 8,
             H = 32: f32 and bf16 carry, 4 chained steps; ms a layer over
             24 layers' states, the bound from the bytes
 15. serve small a 256 x 2 Spark slot pool (8 slots; then the B=64 pool) on
             the card vs the same pool on the CPU's plain path: 12 requests,
             greedy and then top-k 50 / top-p 0.95 through the pool's noise,
             identical tokens; for each B=64 sampled request that differs,
             the first differing token and its draw's margins, and the same
             pool with decode_step_plain on the card against the CPU; the
             leading candidates of each such draw on the three routes, and
             for a request that only the kernel flips, where its carried
             state first parts from the plain pool's
 16. serve main  the serving launcher at Spark 1024 x 24 (random weights
             from seed 0 written as model.safetensors and loaded by
             launch.build_pipeline), 96 slots, chunk 32: 4 requests over HTTP,
             then 192 at once; tokens, sustained tok/s, occupancy, ms a step,
             latency, launches, peak memory, a profile of two chunks; and
             launch --int4 on the same checkpoint: one request, kernel 7 24 a
             step
 17. spark wav small  BiCodec at the golden's reduced config with its state
             dict (tests/goldens/bicodec.npz): mel, semantic and global
             tokens and the wav on the card vs the CPU, and vs the
             reference's recorded outputs
 18. spark wav main  BiCodec at BiCodecConfig() (f32, TF32 off) with the
             xlsr-53-shaped frontend: phase 6's 64 x 256 tokens to wav in
             row batches (every wav finite, tokens x 320 samples), one
             50-token row vs the CPU, a zero-shot tokenize of a 6 s clip (the
             share of tokens equal to the CPU's), SparkPipeline.synthesize
             at 1024 x 24, B=1, 256 new tokens with global tokens, with
             properties (design_voice) and with a prompt wav + text, then 4
             requests through ContinuousTTSService with the codec; ms a
             detokenize batch and per audio second, tokenize ms, synthesize
             wall and tok/s, design ms, launches, peak memory; then a
             scripted interactive_cli session (/voice design, a line, /quit)
             on that pipeline: one finite wav
 19. cosy zs small  the four Cosy goldens (tests/goldens/{s3_onnx,
             campplus_onnx,flow,hift}.npz) through the port's importers on the
             card, at the JAX golden tests' gates; a zero-shot synthesize from
             a prompt wav at LM 256 x 2 (bf16, head x 10) with tiny flow /
             HiFT / S3 / CAM++ on both decode routes, card vs CPU (prompt
             tokens, embedding, generated tokens); cosy_generate_mega_b64 at
             256 x 2, B = 64, 4 steps, card vs CPU on one set of noise
 20. cosy zs main  the 1.5B pairing (RWKV-7 2048 x 24 bf16, FlowConfig(),
             HiFTConfig(), S3TokenizerConfig(), CampplusConfig(), random
             weights): frontend_zero_shot of a 6 s prompt (S3 and CAM++ ms,
             150 tokens, 300 mel frames, the S3 tokens' share equal to the
             CPU's), then synthesize (200 characters, 400 new tokens) on the
             B=1 kernel route and on the rwkv7.decode_step route,
             cross-lingual, instruct and voice conversion of a 6 s source,
             each once warm and once timed: wall, LM and flow s, RTF, LM ms a
             token, launches by kernel, samples = 960 x tokens, peak memory
 21. cosy b64  kernel 1 at 2048 x 24 vs decode_step_plain (2 steps), its ms
             and bound; cosy_generate_mega_b64 at 2048 x 24 bf16, int8
             decode, B = 64, 128 + 256 tokens at top-k 25 / top-p 0.8: audio
             tok/s with the prefill, 8 L + 2 launches a token, peak memory

 22. cosy serve small  the Cosy slot pool (serving/cosy_pool.py) at LM 256 x 2
             f32: 3 requests, 2 slots, 4-step chunks, greedy and top-k 25 /
             top-p 0.8 on the pool's hashed draws, card vs CPU identical,
             overlap identical, the greedy tokens = each request alone
             through cosy_generate fed the pool's draws; wkv7_step L a pool
             step, wkv7_fwd L an admission; the SFM window hop of a tiny SFM
             flow, card vs CPU within 1e-4; the LM as a checkpoint loaded by
             launch.build_cosy_pipeline (bf16), greedy pool card vs CPU
 23. cosy serve main  the path cosy-1.5B-serve-8: a random Cosy LM 2048 x 24
             through launch.cosy_pipeline with random FlowConfig(sfm=True),
             HiFTConfig(), S3TokenizerConfig() and CampplusConfig() codecs,
             CosyTTSService (8 slots, chunk 16, RAS 25 / 0.8, hop 50) behind
             HTTP: 8 concurrent /api/rwkv_tts_stream requests of a
             60-character text with 6 s prompt wavs under the bench's
             400-token cap; then, capped at 100 tokens, the same 8 voices
             stored (--voices-dir) under torch.profiler, one solo stream, 4
             /api/rwkv_tts requests, one mp3 where libmp3lame is present;
             then the SFM levers (sfm, 5 steps, ctx 50, vocode every 2) on 8
             streams: TTFA p50 / p95 pooled and solo, RTF a stream and
             aggregate, the gap between chunks after the first, pool ms a
             step and a chunk, LM / flow / HiFT busy on the wall and on
             their threads' CPU, the process's CPU share, the card's busy
             share and the synchronising calls, wkv7_step 24 a pool step,
             wkv7_fwd 24 an admission, peak memory, every wav finite with
             960 samples a token

 24. xy small  xy_generate at LM 128 x 2 f32 (the reduced vocabularies of
             tests/test_decode_mega_b64.py, heads x 10, temperature 0.01) on
             the rwkv7.decode_step route (B = 8) and on kernel 1 (B = 64),
             card vs CPU on one set of noise: identical frames and n_audio;
             kernel 7 L a step, kernel 1 8 L + 2 a frame, kernel 2 L a
             prefill; a tiny XY_Tokenizer and a tiny Higgs codec, card vs
             CPU: decode wav within 1e-4, encode codes' share equal >= 0.9
 25. xy main  the paths xy-0.4B-b8 and xy-0.4B-b64
             (benchmarks/bench_families_scale.py:73-118): the XY LM 1024 x
             24 bf16 (random, seed 0), 32-token prompts, 256 frames with no
             EOS, B = 8 on rwkv7.decode_step and B = 64 on kernel 1 (int8,
             bf16 carry): frames/s, tokens/s (x 8), audio x realtime (frames
             / 12.5), ms a frame, launches by kernel (24 kernel-7 launches a
             step, 194 kernel-1 launches a frame, 24 kernel-2 a prefill),
             peak memory; XYPipeline.synthesize at B = 1 with
             XYTokenizerConfig() (random): LM s, codec s, codec ms per audio
             second, a wav of 1920 samples a code; a decode_long of 500
             codes (40 s); an encode of a 6 s clip against the CPU's; Higgs
             decode at HiggsConfig() of 256 frames (320 samples a frame)
 26. asr small  kernel 2 at the ASR adapter's (8, 1500, 16), the ASR LLM's
             (8, 1520, 16), S2S's (32, 64, 16) and two-tower's (16, 64, 16)
             prefills with a left-padded mask from right_align_pack, and
             kernel 7 at (8, 16), (32, 16), (16, 16) on fresh state buffers,
             against their plain versions (f32 1e-4, bf16 2e-2), their ms,
             device ms and bounds; tiny f32 configs (LM 128 x 2, heads x 10)
             of both ASR variants, S2S on both heads and the two-tower model,
             card vs CPU: greedy and fed-noise sampled tokens equal, exact
             launches; the Whisper encoder at whisper-large-v3's widths on 1 s,
             card vs CPU in f32 (1e-4)
 27. asr main  the paths asr-0.4B-whisper-large-v3 (transcribe: ASR LLM 1024
             x 24, adapter 1024 x 6, the large-v3 encoder, B = 8 x 30 s, 32
             greedy tokens: x realtime, RTF, encoder / adapter / prefill /
             decode ms, 30 kernel-2 and 768 kernel-7 launches), s2s-0.4B-b32
             (B = 32, 64 + 256 audio-head tokens: tok/s, 24 and 6,144) and
             two-tower-0.4B-b16 (B = 16, 64 + 256 tokens: tok/s, 48 and 6,144)
             (benchmarks/bench_families_scale.py:29-70, 157-220; random
             weights, matrices bf16; a warm-up and two timed calls each)
 28. train tasks small  kernels 4-5 vs wkv7_fused_plain at the train tasks'
             shapes: Cosy (8, 2048, 32), the ASR adapter (8, 1500, 16) with a
             right-padded mask, the ASR LLM's packed (8, 1584, 16) and the
             two-tower audio tower's (8, 2176, 16) with left-padded masks
             (v zero at the pads; bf16 2e-2, and f32 1e-4 at the ASR shapes),
             two calls bit-identical, saving / primal / backward device ms, the
             plain version's ms at the Cosy shape, the bounds;
             then each of the nine tasks of the train CLI at LM 128 x 2 f32
             (FlowConfig(sfm=True) for sfm_flow, its draws fixed;
             spark_global on the unfused pair, kernels 2-3): one train step on
             the card vs the CPU (loss 1e-4, grad norm 1e-3), 2 L / L
             launches of the pair a step a stack
 29. train tasks main  each task through train.cli.main (asr through
             Trainer) at its family's width, random weights from seed 0, one
             warm-up and 3 timed steps (5 steps through the CLI: its metrics
             read of a step waits for the next): spark_properties 1024 x 24 (4 rows, 8
             sequences x 2048), spark_global (64 x 128), cosy 2048 x 24 (8 x
             2048, prompt drop 0.5), xy, s2s (audio and text batches in turn) and
             tts_two_tower (128 + 2048) at 1024 x 24, asr-0.4B with the
             whisper-large-v3 encoder (8 x 30 s, 16 + 4 + 64 tokens), sfm_flow
             (8 x 250 tokens), spark 2048 x 24 with adafactor (2 x 2048); then
             one mu_bf16 step at 1024 x 24: finite losses, none skipped, the
             first loss within 0.5 of ln(vocabulary) (one head), exact fused
             launches (ASR 60 / 30, two-tower 96 / 48, sfm_flow 0 a step), the
             Whisper leaves bit-identical; ms a step, positions/s, peak memory
 30. cosy long  CosyPipeline.synthesize_long at phase 20's 1.5B pairing with
             the world tokenizer (the B=1 kernel route) from a 6 s prompt, on a
             zh and an en paragraph of 7-8 sentences (digits, a date, a time,
             a percentage, a phone number, a unit), chunks of <= 80 text
             tokens, <= 400 speech tokens each: the normalized text, the
             chunks (= the host's text frontend), each chunk's tokens and
             decode steps, the wall by frontend / LM / flow / HiFT, the RTF;
             = the chunks' synthesize(chunk_i, seed + i) on the same frontend
             outputs (tokens equal, wav within 1e-5, bit-identical or not);
             kernel 2 24 a chunk, kernel 6 121 a decode step
 31. long train  train.cli --task spark_properties --mark-phonemes-prob 0.5
             at 1024 x 24, 4 rows (8 sequences <= 2048) a step, rows mixing zh
             and en words of the native tables: the first batch = the host's
             collate_with_properties(rng=random.Random(0)); one warm-up and 3
             timed steps: finite losses, none skipped, ms a step, positions/s,
             peak memory, the texts marked, 48 / 24 fused launches a step
 32. seed tts  a 4-row zh/meta.lst with 6 s prompt clips: generate_testset
             through phase 30's pipeline, evaluate_wer with asr_transcribe_fn
             at asr-0.4B-whisper-large-v3's widths (32 steps; 30 kernel-2 and
             768 kernel-7 launches a transcribe; n_ref_tokens = normalize_text's
             count), evaluate_sim with campplus_embed_fn (values in [-1, 1]),
             whisper_transcribe_fn on a tiny saved Whisper model; ms a row by
             stage; WER and SIM of random weights
 33. ranking demo  rwkvtts_torch.eval.ranking_demo.run on the card (8
             sentences, 300 + 300 steps, 128 x 2 at head size 64): trained WER
             < 0.35, untrained > 0.7, gap > 0.4; final losses, wall, launches
 34. spark generate  greedy_spark_generate at spark.default_config(1024, 24)
             (matrices bf16), B = 8, 128 + 128 tokens (256 before phases
             43-46 took the time): = spark_generate at top-k 1; 24 kernel-2
             launches, 24 kernel-7 launches a step over 128 steps; ms a token
 35. corpus  g++ of the tar streamer and the world-tokenizer trie (seconds);
             64 seeded utterances of 3-20 s at 16 kHz with zh / en texts and
             speaker properties through write_shards, 4 shards of 16;
             stream_tars (the C++ streamer) = read_tars_plain (tarfile: keys,
             texts, bit-identical audio), each one's MB/s; shard 0 cut half
             way into a member: each whole sample once on both paths, the cut
             sample dropped; the trie's ids = the Python matcher's on the
             texts, each one's encode ms
 36. extract  extract_spark_tokens at BiCodecConfig() with the xlsr-53-shaped
             frontend (and the model directory it is written to, ~1.3 GB),
             run_sharded with 2 spawned workers = the single-process rows,
             extract_xy_tokens at XYTokenizerConfig(), extract_higgs_tokens at
             HiggsConfig() with a random hubert-base teacher, S3 rows and
             CAM++ x-vector rows (2 a speaker) at their published widths: each codec's ms
             per audio second, the rows' shapes and ranges
 37. train wds  train.cli --task spark --data-format webdataset --codec-dir
             at 1024 x 24, B = 8 rows padded to 2048, 1 warm-up + 3 timed
             steps: every row's inline tokens = phase 36's row of its key,
             48 / 24 fused launches a step, none skipped; the inline
             tokenization's ms and the step's apart, positions/s, peak
             memory, the card's busy share with and without the tokenization
             in front (torch.profiler, CUDA activity only, 3 steps each);
             one spark_properties step over the tars through its own
             collator (SPCT tokens)
 38. export  spark_to_flat of the trained model, blinkdl_to_rwkv7 on the
             card: its logits on flat_ids_from_parts' ids = the Spark model's
             semantic logits within 2e-2 of the largest (bf16), zeros beyond;
             cast_fp32_to_bf16 of the export
 39. quant small  the int4 pack on the card = the CPU's; rwkv7.decode_step
             at 256 x 2 f32 on the int8-unfused, int8-fused and int4 trees,
             card vs CPU (1e-4, 4 chained in-place steps, kernel 7 L a step);
             sample / ras_sample with rank_bf16, card = CPU on one set of
             noise; the new refusals raise
 40. cosy quant serve  phase 23's 1.5B pairing through launch.cosy_pipeline
             with --int8 and with --int4: CosyTTSService, 3 streams (2 prompt
             wavs, 1 stored voice), <= 100 tokens: TTFA, pool ms a step (LM
             ms a token), 24 kernel-7 launches a pool step, 24 kernel-2 an
             admission, finite wavs of 960 samples a token, beside phase 23's
             bf16 numbers; the model decode step at B = 8 on the bf16, int8
             and int4 trees and its dequantization's ms
 41. quant quality  rwkvtts_torch.eval.quant_quality at Spark 1024 x 24
             (int8, int4-g64, state-bf16, int8+state-bf16 at B = 8, the B=64
             kernel 1 with 194 launches a token) and 2048 x 24 (int8,
             int4-g64), and the bf16-unfused control at both, 16 greedy
             steps (the JAX script's 256 cut for time; 32 before phases 43-46):
             every JSON line, agreements in [0, 1]
 42. flow non-causal  the estimator at FlowConfig()'s widths with
             causal=False, card vs CPU (f32, TF32 off, 1e-4), and a 10-step
             CFM solve on both (1e-4)
 43. dist nccl  one torchrun rank over NCCL (parallel/dryrun.py): the mesh
             train step of Spark 256 x 2 bf16 (dp = fsdp = 1: every gather
             and reduce-scatter issued on groups of one), two steps = the
             single-process step bit for bit (deterministic algorithms on
             both sides)
 44. dist small  4 spawned gloo ranks on the one card, Spark 256 x 2 f32:
             dp=2 x fsdp=2 on 8 x 256 and dp=2 x sp=2 (wkv_spans 4) on 4
             packed lines of 256, each against the single-process step on the
             card (loss 1e-4, grad norm 1e-3, parameters 2e-4 / 2e-6, first
             moments 1e-4); the fsdp checkpoint restored in one process = the
             gathered state; the sp route on kernels 2-3 (ops/wkv7.wkv7_spans)
             against wkv7_chunked_sp at (2, 512, 16) in 4 spans, f32, random
             decays and w_raw = -0.5: y, state and every gradient within 1e-4,
             2 / 2 launches a call
 45. dist main  train.cli under torchrun, 2 gloo ranks on the one card, Spark
             1024 x 24: --mesh fsdp=2 at B = 8 x 2048 global and --mesh sp=2 at
             4 x 2048, 1 warm-up + 2 timed steps: finite losses near ln 8193,
             none skipped, 48 / 24 fused launches a step a rank under fsdp and
             96 / 48 of kernels 2 / 3 under sp, ms a step, the part in
             collectives, peak memory a rank (gloo on one card: not a
             multi-GPU number)
 46. dp pool  the Spark pool at 1024 x 24, 96 slots as 2 groups on the one
             card against 1 group: 144 requests of 32 tokens (48 queued for
             the slots the first chunk frees), greedy and sampled, the same
             tokens; kernel 7 24 launches a step a group; ms
             a pool step
They alone: ``python3 -c "import chip_smoke as c; c.dist_of_tree()"``.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# the kernels' C entry points and the TPU kernels they replace
WKV7_SOURCE = "rwkvtts_torch/csrc/wkv7_fwd.cu"
WKV7_REPLACES = "rwkvtts_tpu/ops/wkv7_pallas.py:269"
DECODE_SOURCE = "rwkvtts_torch/csrc/decode_b64.cu"
DECODE_REPLACES = "rwkvtts_tpu/ops/decode_mega_b64.py:289"
WKV7_BWD_SOURCE = "rwkvtts_torch/csrc/wkv7_bwd.cu"
WKV7_BWD_REPLACES = "rwkvtts_tpu/ops/wkv7_pallas.py:308"
FUSED_SOURCE = "rwkvtts_torch/csrc/wkv7_fused.cu"
FUSED_FWD_REPLACES = "rwkvtts_tpu/ops/wkv7_pallas.py:752"
FUSED_BWD_REPLACES = "rwkvtts_tpu/ops/wkv7_pallas.py:796"
DECODE_B1_SOURCE = "rwkvtts_torch/csrc/decode_b1.cu"
DECODE_B1_REPLACES = "rwkvtts_tpu/ops/decode_mega.py:330"
STEP_SOURCE = "rwkvtts_torch/csrc/wkv7_step.cu"
STEP_REPLACES = "rwkvtts_tpu/ops/wkv7_step_pallas.py:93"

B = 64
PROMPT, NEW_TOKENS = 128, 256
# the training main path: batch x tokens, full Spark 0.4B width and depth
TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_LAYERS = 8, 2048, 16, 24
TRAIN_WARM, TRAIN_TIMED = 2, 6
# the Cosy streaming main path: RWKV-7 1.5B LM (2048 x 24) + CosyVoice2 flow
# + HiFT, 200-character texts, 75 prompt tokens, 400 new tokens each
COSY_C, COSY_L = 2048, 24
COSY_TEXT, COSY_PROMPT, COSY_NEW = 200, 75, 400

# the serving main path: Spark 0.4B behind the launcher's defaults
SERVE_HIDDEN, SERVE_LAYERS, SERVE_H = 1024, 24, 16
SERVE_SLOTS, SERVE_CHUNK, SERVE_MAX_NEW, SERVE_REQUESTS = 96, 32, 256, 192

# the Spark text->wav route: the LM of phase 6 with BiCodec, the detokenize
# row batch, the row held against the CPU, the zero-shot clip, synthesize's
# new tokens, the requests served with the codec
WAV_HIDDEN, WAV_LAYERS = 1024, 24
WAV_ROWS, WAV_CHECK_TOKENS, WAV_PROMPT_S, WAV_NEW, WAV_REQUESTS = 16, 50, 6.0, 256, 4
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
GOLDEN_BICODEC = os.path.join(GOLDEN_DIR, "bicodec.npz")

# the Cosy server (bench_pooled_streaming.py's defaults): 8 slots, 16-step
# chunks, 50-token hops, 8 concurrent 60-character streams under the
# bench's cap of SERVE_COSY_NEW tokens; random weights draw no EOS, so each
# stream runs to the hub's maximum, min(20 x its content tokens, the cap):
# 260 tokens for these texts; the other bursts cap their decode at
# SERVE_COSY_SHORT tokens (a hop and the tail) to keep the phase short
SERVE_COSY_STREAMS, SERVE_COSY_CHUNK, SERVE_COSY_HOP = 8, 16, 50
SERVE_COSY_TEXT, SERVE_COSY_NEW, SERVE_COSY_SHORT = 60, 400, 100

# the Cosy zero-shot route: the 1.5B pairing with S3 and CAM++ at their
# published widths, a 6 s prompt, 200-character texts, 400 new tokens (the
# warm-up runs decode ZS_WARM_NEW); then Cosy B=64 offline generation at
# 2048 x 24 (bench_generate_mega_ab.py --family cosy --hidden 2048), top-k
# 25 / top-p 0.8
ZS_PROMPT_S, ZS_NEW, ZS_WARM_NEW = 6.0, 400, 16
COSY_B64_NEW = 256

# the XY paths (benchmarks/bench_families_scale.py:73-118): the XY LM at
# 1024 x 24, 32-token prompts, 256 frames with no EOS, B = 8 on
# rwkv7.decode_step (xy-0.4B-b8) and B = 64 on kernel 1 (xy-0.4B-b64);
# XYPipeline.synthesize's utterance, whose prompt [S0]{XY_TEXT}[CTL0] is
# XY_SYNTH_PROMPT tokens
XY_C, XY_L, XY_PROMPT, XY_FRAMES, XY_B = 1024, 24, 32, 256, 8
XY_TEXT = "The quick brown fox jumps over the lazy dog by the river bank."
XY_SYNTH_PROMPT = 16

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FMA, and bf16
# and TF32 tensor-core FLOP/s; the bound of a kernel is the larger of its
# bytes over the first and its operations over the peak for their type
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12


# host seconds before and after the launches inside a retried profiler session
PROFILE_PAD_S = 0.05
# clock cycles of the sleeping kernel queued_ms puts before its first window
# (~10 ms on an H100 at 1.98 GHz; the host issues a few calls in well under
# 1 ms unless it is held up), and the windows it takes at most, each behind a
# sleep four times as long as the last (the fourth ~0.65 s)
QUEUE_SLEEP_CYCLES = 20_000_000
QUEUE_SLEEP_TRIES = 4


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int, per_call: int) -> float:
    """Device milliseconds of the kernels whose name holds `kernel`, a
    launch, over `reps` calls of fn (each launching it `per_call` times),
    from torch.profiler, after one warm call. Late in a long process a
    short session can keep none of its launches; a session that kept under
    half of them is run again, at most twice more, with PROFILE_PAD_S of
    host time before the launches and after the synchronize inside the
    session, so that device times a few milliseconds off the host's window
    still fall inside it. Each session that kept too few says how many
    device records it kept in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = reps * per_call
    for attempt in range(3):
        pad = PROFILE_PAD_S if attempt else 0.0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        t, n, n_all = 0.0, 0, 0
        for name, (us, c) in kernel_totals(prof).items():
            n_all += c
            if kernel in name:
                t, n = t + us, n + c
        check(n <= want, f"profiled {n} launches of {kernel}, more than the {want} issued")
        if n >= 0.5 * want:
            if attempt:
                print(f"device_ms: a session padded by {pad} s kept {n} of {want} launches "
                      f"of {kernel}")
            return t / 1e3 / n
        print(f"device_ms: the profiler kept {n} of {want} launches of {kernel} and {n_all} "
              f"device records in all (session {attempt + 1} of 3, padded by {pad} s)")
    check(False, f"profiled {n} launches of {kernel}, want {want}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# 3. WKV7 forward
# ---------------------------------------------------------------------------


def wkv_inputs(g: torch.Generator, Bn: int, T: int, H: int, dtype):
    """Inputs in the model's ranges: w_raw <= -0.5, z = -kk and b = kk * a
    with kk unit-norm per head."""
    dev = g.device
    f = lambda: torch.randn(Bn, T, H, 64, generator=g, device=dev)
    r, k, v = f(), 0.3 * f(), f()
    w_raw = -0.5 - f().abs()
    kk = torch.nn.functional.normalize(f(), dim=-1)
    a = torch.sigmoid(f())
    ins = [x.to(dtype).contiguous() for x in (r, w_raw, k, v, -kk, kk * a)]
    state = 0.1 * torch.randn(Bn, H, 64, 64, generator=g, device=dev)
    resets = torch.rand(Bn, T, generator=g, device=dev) < 0.05
    return ins, state, resets


def phase_wkv7(dev) -> dict:
    from rwkvtts_torch import _build
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops.wkv7 import wkv7_scan

    lib = _build.library()
    for name, Bn, T, H, _ in WKV_FWD_SHAPES:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            plan = wkv7_cuda.fwd_plan(Bn, T, H, dtype)
            check(lib.wkv7_fwd_smem_bytes(code) == plan["smem_bytes"],
                  "wkv7 plan: shared memory bytes differ from the library's")
        print(f"wkv7: plan {name} ({Bn}, {T}, {H}) bf16: {wkv7_cuda.fwd_plan(Bn, T, H)}")

    g = torch.Generator(device=dev).manual_seed(1)

    def gate(what, ins, st, rs, tol):
        y_k, s_k = wkv7_cuda.wkv7_fwd(*ins, st, rs)
        y_p, s_p = wkv7_scan(*(x.float() for x in ins), st, rs)
        ey, es = rel(y_k, y_p), rel(s_k, s_p)
        print(f"wkv7: {str(ins[0].dtype)[6:]} {what}: y rel {ey:.3e}, state rel {es:.3e} "
              f"(limit {tol:g})")
        check(y_k.dtype == ins[0].dtype and s_k.dtype == torch.float32, "wkv7 output dtypes")
        check(ey <= tol and es <= tol, f"wkv7 kernel disagrees with wkv7_scan: {what}")

    tols = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    for dtype, tol in tols:
        for with_state in (True, False):
            ins, state, resets = wkv_inputs(g, 4, 200, 16, dtype)
            st, rs = (state, resets) if with_state else (None, None)
            gate(f"B=4 T=200 H=16 state+resets={with_state}", ins, st, rs, tol)
    # the Cosy prefill, the Spark and Cosy servers' largest admissions and
    # the XY prefills, with state and resets
    for name, Bn, T, H, saving in WKV_FWD_SHAPES[1:]:
        if saving:
            continue
        for dtype, tol in tols:
            ins, state, resets = wkv_inputs(g, Bn, T, H, dtype)
            gate(f"{name} ({Bn}, {T}, {H}) state+resets", ins, state, resets, tol)
    # every w_raw at -0.5, the fastest decay the model's clamp allows
    ins, state, resets = wkv_inputs(g, 4, 200, 16, torch.float32)
    ins[1] = torch.full_like(ins[1], -0.5)
    resets[0, 16] = resets[0, 37] = resets[0, 38] = True
    gate("B=4 T=200 H=16 state+resets, every w_raw -0.5", ins, state, resets, 1e-4)

    # the same bits for two calls, anchors included
    for Bn, T, H, dtype in ((2, 200, 16, torch.float32), (2, 200, 16, torch.bfloat16),
                            (*WKV_FWD_SHAPES[1][1:4], torch.bfloat16),
                            (*WKV_FWD_SHAPES[0][1:4], torch.bfloat16)):
        ins, state, resets = wkv_inputs(g, Bn, T, H, dtype)
        runs = [wkv7_cuda._fwd(*ins, state, resets, save=True) for _ in range(2)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"wkv7: {str(dtype)[6:]} ({Bn}, {T}, {H}) saving, two calls: y, final state and "
              f"anchors bit-identical: {same}")
        check(same, "wkv7 forward: two calls differ")

    # the main path's shape: the prefill of 64 prompts of 128 tokens, H = 16,
    # bf16, a zero initial state and no resets
    ins, _, _ = wkv_inputs(g, B, PROMPT, 16, torch.bfloat16)
    state = torch.zeros(B, 16, 64, 64, device=dev)
    y_k, s_k = wkv7_cuda.wkv7_fwd(*ins, state, None)
    y_p, s_p = wkv7_scan(*(x.float() for x in ins), state, None)
    ey, es = rel(y_k, y_p), rel(s_k, s_p)
    check(ey <= 2e-2 and es <= 2e-2, "wkv7 kernel disagrees at the main path's shape")
    plain_ms = cuda_ms(lambda: wkv7_scan(*ins, state, None), 2)
    print(f"wkv7: bf16 B={B} T={PROMPT} H=16 (main path): y rel {ey:.3e}, state rel "
          f"{es:.3e}; plain {plain_ms:.4f} ms")
    times = wkv7_fwd_times()
    main = times["prefill"]
    return {"name": "wkv7_fwd", "route": "cuda", "source": WKV7_SOURCE,
            "replaces": WKV7_REPLACES, "max_abs_err": max_abs(y_k, y_p),
            "ms": main["ms"], "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None, "by_shape": times}


# kernel 2's shapes on the paths that run it: (name, B, T, H, saving forward)
WKV_FWD_SHAPES = (("prefill", B, PROMPT, 16, False), ("cosy", 1, 320, 32, False),
                  ("admission", 8, PROMPT, 16, False),
                  ("cosy admission", SERVE_COSY_STREAMS, 256, COSY_C // 64, False),
                  ("xy b64 prefill", B, XY_PROMPT, XY_C // 64, False),
                  ("xy b8 prefill", XY_B, XY_PROMPT, XY_C // 64, False),
                  ("xy synthesize prefill", 1, XY_SYNTH_PROMPT, XY_C // 64, False),
                  ("train", TRAIN_B, TRAIN_T, TRAIN_H, True))


def wkv7_fwd_times(what: str = "wkv7 fwd", reps: int = 20, shapes=WKV_FWD_SHAPES) -> dict:
    """Milliseconds of kernel 2 at the shapes of the paths that run it
    (`shapes`, by default WKV_FWD_SHAPES; phase 26 passes the ASR, S2S and
    two-tower prefills'), bf16 inputs in the model's ranges (seed 3): the
    primal with a zero state at the generation prefill, the Cosy prefill
    and one admission bucket of the server, and the saving forward of the
    unfused training path (no state). Each a call on CUDA events (`ms`:
    back to back, so a call shorter than the wrapper's host time reads the
    host), the kernel's device time (torch.profiler), and the bound. From
    the root of another checkout, with this file copied there, it times
    that tree's kernel under the same measurement, e.g. the parent's."""
    from rwkvtts_torch.ops import wkv7_cuda

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for name, Bn, T, H, saving in shapes:
        ins, _, _ = wkv_inputs(g, Bn, T, H, torch.bfloat16)
        if saving:
            x = [t.detach().clone().requires_grad_() for t in ins]
            fn = lambda: wkv7_cuda.wkv7(*x)
            moved = train_shape_bytes(ins, 7)
        else:
            state = torch.zeros(Bn, H, 64, 64, device=dev)
            fn = lambda: wkv7_cuda.wkv7_fwd(*ins, state, None)
            moved = nbytes(*ins, ins[3], state, state)  # + y and the final state
        ms, dms = cuda_ms(fn, reps), device_ms(fn, "wkv7_fwd", reps, 1)
        # each (b, t, h): sa (1 FMA), the update (2 FMA + 1 mul), y (1 FMA)
        # on 64 x 64 elements, TF32 on the tensor cores (the kernel's products)
        bms, by = bound_ms(moved, 9 * 4096 * Bn * T * H, TF32_TC_FLOPS)
        out[name] = {"ms": ms, "device_ms": dms, "bound_ms": bms, "bound_by": by}
        print(f"{what}: {name} ({Bn}, {T}, {H}) bf16 {'saving' if saving else 'primal'}: "
              f"{ms:.4f} ms a call, device {dms:.4f} ms, bound {bms:.4f} ms ({by})")
    return out


# ---------------------------------------------------------------------------
# 4. Decode step
# ---------------------------------------------------------------------------


def randomize(params: dict, g: torch.Generator) -> None:
    """Make the lora-in, output and FFN value matrices nonzero (the init
    zeroes them) so every term of the step is exercised."""
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        t = tree[name]
        tree[name] = torch.randn(t.shape, generator=g, device=t.device) * t.shape[-2] ** -0.5


def decode_vs_plain(dev, C: int, L: int, seed: int, steps: int):
    """The B=64 step on the card vs decode_step_plain on the card, `steps`
    chained steps from one state, at C x L with random weights from `seed`:
    hidden and state within 2e-2. Returns the pack, the kernel's state, the
    last input, the largest |hidden difference| and the config."""
    from rwkvtts_torch.models import rwkv7
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    cfg = rwkv7.RWKV7Config(vocab_size=8193, hidden_size=C, num_layers=L)
    H = cfg.num_heads
    g = torch.Generator(device=dev).manual_seed(seed)
    params = rwkv7.init_params(g, cfg)
    randomize(params, g)
    mega = dmb.pack_mega_b64(params, cfg)
    del params
    bf = lambda *shape, s: (s * torch.randn(*shape, generator=g, device=dev)).to(torch.bfloat16)
    st_k = {"att_x": bf(L, B, C, s=0.5), "wkv": bf(L, B, H, 64, 64, s=0.1),
            "ffn_x": bf(L, B, C, s=0.5)}
    st_p = {k: v.clone() for k, v in st_k.items()}
    err = 0.0
    for i in range(steps):
        x = torch.randn(B, C, generator=g, device=dev)
        h_k, _ = dmb.decode_step_mega_b64(mega, cfg, x, st_k)
        h_p, _ = dmb.decode_step_plain(mega, cfg, x, st_p)
        eh = rel(h_k, h_p)
        err = max(err, max_abs(h_k, h_p))
        print(f"decode: {C} x {L}: step {i}: hidden rel {eh:.3e} (limit 2e-2)")
        check(bool(torch.isfinite(h_k).all()), "decode hidden is not finite")
        check(eh <= 2e-2, f"decode kernel disagrees with decode_step_plain at {C} x {L}")
    for leaf in ("att_x", "ffn_x", "wkv"):
        es = rel(st_k[leaf], st_p[leaf])
        print(f"decode: {C} x {L}: after {steps} steps: state {leaf} rel {es:.3e} (limit 2e-2)")
        check(es <= 2e-2, f"decode state {leaf} disagrees at {C} x {L}")
    return mega, st_k, x, err, cfg


def phase_decode(dev) -> tuple[dict, dict]:
    from rwkvtts_torch import _build
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    lib = _build.library()
    for C in (1024, 2048):
        plan = dmb.launch_plan(C)
        for name, pr in plan["products"].items():
            print(f"decode: plan C={C} {name}: {pr}")
            check(lib.decode_b64_gemm_smem_bytes(pr["k_piece"]) == pr["smem_bytes"]
                  <= dmb.SMEM_LIMIT, f"decode plan {name}: shared memory")
        check(lib.decode_b64_workspace_bytes(C) == plan["workspace_bytes"],
              "decode plan: workspace bytes")
    # the width the Cosy B=64 path needs, at 2 layers
    decode_vs_plain(dev, 2048, 2, 5, 2)
    mega, st_k, x, err, cfg = decode_vs_plain(dev, 1024, 24, 2, 4)
    L, C = cfg.num_layers, cfg.hidden_size

    # deterministic: two calls on the same inputs give the same bits
    runs = []
    for _ in range(2):
        st = {k: v.clone() for k, v in st_k.items()}
        h, _ = dmb.decode_step_mega_b64(mega, cfg, x, st)
        runs.append({"h": h, **st})
    same = {k: torch.equal(runs[0][k], runs[1][k]) for k in runs[0]}
    print(f"decode: two calls on the same inputs, bit-identical: {same}")
    check(all(same.values()), "decode step is not deterministic")

    dmb.reset_launches()
    dmb.decode_step_mega_b64(mega, cfg, x, st_k)
    per_step = dict(dmb.kernel_launches)
    want = {"ln_rows": 2 * L + 2, "gemm_i8": 5 * L, "wkv_glue": L}
    check(per_step == want and dmb.launches == 8 * L + 2,
          f"decode launches a step {per_step}, want {want} (8 L + 2 = {8 * L + 2})")
    st_p = {k: v.clone() for k, v in st_k.items()}
    ms = cuda_ms(lambda: dmb.decode_step_mega_b64(mega, cfg, x, st_k), 20)
    # each kernel's own device time: the chain without programmatic
    # dependent launch, whose spans would hold each kernel's wait
    profile = decode_profile("decode", mega, cfg, x, st_k, pdl=False)
    print(f"decode: host-timed {ms:.4f} ms a step with programmatic dependent launch, "
          f"{profile['host_ms']:.4f} ms without")
    plain_ms = cuda_ms(lambda: dmb.decode_step_plain(mega, cfg, x, st_p), 3)
    # bytes: every packed weight once, the state read and written, x and h;
    # operations: the int8 products on the bf16 tensor cores, 2 x 64 FLOP a weight
    leaves = [t for t in _leaves(mega) if torch.is_tensor(t)]
    weights = nbytes(*leaves)
    q8 = sum(t.numel() for t in leaves if t.dtype == torch.int8)
    bms, by = bound_ms(weights + 2 * nbytes(*st_k.values()) + 2 * nbytes(x),
                       2 * B * q8, BF16_TC_FLOPS)
    print(f"decode: C={C} L={L} B={B}: {per_step} launches a step; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms a step, bound {bms:.4f} ms ({by})")
    return ({"name": "decode_b64_step", "route": "cuda", "source": DECODE_SOURCE,
             "replaces": DECODE_REPLACES, "max_abs_err": err, "ms": ms,
             "ms_nopdl": profile["host_ms"], "device_ms_nopdl": profile["device_ms"],
             "busy_nopdl": profile["busy"],
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
             "library_ms": None}, per_step)


def decode_profile(what: str, mega, cfg, x, state, **step_kw) -> dict:
    """The B=64 step's host-timed ms (20 steps) and step_profile of it;
    step_kw goes to decode_step_mega_b64."""
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    step = lambda: dmb.decode_step_mega_b64(mega, cfg, x, state, **step_kw)
    return step_profile(what, step, cuda_ms(step, 20))


def decode_profile_of_tree(what: str = "decode") -> dict:
    """decode_profile at 1024 x 24 on phase_decode's weights (seed 2, one
    step checked against decode_step_plain) with whichever rwkvtts_torch is
    imported, the kernel's own launch options: from the root of another
    checkout, with this file copied there, it profiles that tree's kernel
    under the same measurement, e.g. the parent's, which has no
    programmatic dependent launch."""
    dev = torch.device("cuda", 0)
    mega, st, x, _, cfg = decode_vs_plain(dev, 1024, 24, 2, 1)
    return decode_profile(what, mega, cfg, x, st)


def step_profile(what: str, fn, host_ms: float, steps: int = 8) -> dict:
    """Device time a step by kernel (template arguments kept, parameter
    lists dropped) over `steps` calls of fn under torch.profiler, their
    sum, and the device busy share of the host-timed step `host_ms`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for name, (us, c) in kernel_totals(prof).items():
        short = name.replace("(anonymous namespace)::", "").split("(")[0]
        t, n = by_name.get(short, (0.0, 0))
        by_name[short] = (t + us / 1e3 / steps, n + c / steps)
    device = sum(t for t, _ in by_name.values())
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"{what}: profile: {t:.4f} ms, {n:.1f} launches a step  {name}")
    print(f"{what}: profile: device {device:.4f} ms a step of {host_ms:.4f} ms host-timed, "
          f"busy share {device / host_ms:.3f}")
    return {"device_ms": device, "host_ms": host_ms, "busy": device / host_ms,
            "by_kernel_ms": {k: t for k, (t, _) in by_name.items()}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# 5. Small generation: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------


def left_padded_prompt(g: torch.Generator, T: int):
    from rwkvtts_torch.models import spark

    tokens = torch.randint(0, 4000, (B, T), generator=g)
    modality = torch.full((B, T), spark.MOD_TEXT)
    modality[:, -1] = spark.MOD_TAG
    tokens[:, -1] = spark.TAG_START_TTS
    mask = torch.ones(B, T, dtype=torch.int32)
    for b, n in enumerate(torch.randint(0, T // 2, (B,), generator=g).tolist()):
        mask[b, :n] = 0
        modality[b, :n] = spark.MOD_PAD
        tokens[b, :n] = 0
    return tokens, modality, mask


def phase_small(dev) -> None:
    from rwkvtts_torch.infer.generate import spark_generate_mega_b64
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    cfg = spark.default_config(hidden_size=256, num_layers=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    params = spark.init_params(g, cfg)
    randomize(params, g)
    params["head"] = 10.0 * params["head"]  # greedy gaps far above rounding noise
    prompt = left_padded_prompt(g, 8)
    n_new, V = 8, cfg.backbone.vocab_size
    out = {}
    for where in ("cpu", dev):
        p = rwkv7.tree_map(lambda t: t.to(where), params)
        mega = dmb.pack_mega_b64(p, cfg.backbone)
        out[str(where)] = spark_generate_mega_b64(
            p, mega, cfg, *(t.to(where) for t in prompt), max_new_tokens=n_new,
            top_k=1, top_p=1.0, noise=torch.zeros(n_new, B, V, device=where))
    (t_cpu, _), (t_gpu, _) = out["cpu"], out[str(dev)]
    same = (t_gpu.cpu() == t_cpu).float()
    first, agree = same[:, 0].mean().item(), same.mean().item()
    # the first token depends only on the f32 prefill and must match; later
    # ones go through the int8 decode step, whose bf16 rounding points can
    # flip a near-tie, and a flip changes the rest of its row
    print(f"small: hidden 256 x 2 layers, B={B}, 8 + {n_new} tokens, greedy, vs the "
          f"plain path on the CPU: first token {first:.4f} equal (limit 1), "
          f"all tokens {agree:.4f} equal (limit 0.95)")
    check(first == 1.0 and agree >= 0.95, "small generation disagrees with the plain path")


# ---------------------------------------------------------------------------
# 6. Main path
# ---------------------------------------------------------------------------


def phase_main(dev, card: str, per_step: dict) -> dict:
    from rwkvtts_torch.infer.generate import spark_generate_mega_b64
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import wkv7_cuda

    cfg = spark.default_config(hidden_size=1024, num_layers=24)
    t0 = time.perf_counter()
    params = spark.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)
    mega = dmb.pack_mega_b64(params, cfg.backbone)
    torch.cuda.synchronize()
    print(f"main: Spark {cfg.backbone.hidden_size} x {cfg.backbone.num_layers} params "
          f"and int8 pack built in {time.perf_counter() - t0:.1f} s")

    def run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        tokens = torch.randint(0, 4000, (B, PROMPT), generator=g, device=dev)
        modality = torch.full((B, PROMPT), spark.MOD_TEXT, device=dev)
        modality[:, -1] = spark.MOD_TAG
        mask = torch.ones(B, PROMPT, dtype=torch.int32, device=dev)
        return spark_generate_mega_b64(
            params, mega, cfg, tokens, modality, mask, max_new_tokens=NEW_TOKENS,
            temperature=1.0, top_k=50, top_p=0.95, generator=g)

    run(1)
    torch.cuda.synchronize()
    wkv7_cuda.reset_launches()
    dmb.reset_launches()
    t0 = time.perf_counter()
    toks, lengths = run(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"], "decode_b64_step": dmb.launches}
    by_kernel = dict(dmb.kernel_launches)

    check(toks.shape == (B, NEW_TOKENS) and lengths.shape == (B,), "output shapes")
    check(bool(((toks >= 0) & (toks <= cfg.eos_token_id)).all()), "token out of [0, 8192]")
    check(bool(((lengths >= 0) & (lengths <= NEW_TOKENS)).all()), "length out of range")
    check(launches["wkv7_fwd"] == cfg.backbone.num_layers,
          f"wkv7 kernel launched {launches['wkv7_fwd']} times in the prefill")
    for name, n in per_step.items():
        check(by_kernel[name] >= NEW_TOKENS * n,
              f"decode kernel {name} launched {by_kernel[name]} times, "
              f"want >= {NEW_TOKENS} x {n}")
    tps = B * NEW_TOKENS / seconds
    print(f"main: launches {launches}, decode by kernel {by_kernel}")
    print(f"main: B={B}, {PROMPT} + {NEW_TOKENS} tokens: {seconds:.4f} s, "
          f"{tps:.1f} audio tok/s on {card}; mean length {lengths.float().mean().item():.1f}")
    return {"launches": launches, "by_kernel": by_kernel, "tok_per_s": tps, "toks": toks,
            "lengths": lengths}


def end_to_end_of_tree(what: str = "e2e",
                       paths: tuple = ("gen", "train", "cosy", "serve")) -> dict:
    """The main paths' end-to-end numbers (phases 6, 10, 13 and 16:
    generation tok/s, the fused and the unfused train step, Cosy TTFA, RTF
    and LM ms a token, the server's sustained tok/s; `paths` picks among
    them) with whichever rwkvtts_torch is imported, without the kernel
    phases' checks: from the root of another checkout, with this file
    copied there, it measures that tree the same way, e.g. the parent, in
    turns with this one."""
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {}
    if "gen" in paths:
        out["gen_tok_per_s"] = phase_main(dev, card, {})["tok_per_s"]
    if "train" in paths:
        train = phase_train_main(dev, card)
        out.update(train_step_ms=train["step_ms"], unfused_step_ms=train["unfused_step_ms"])
    if "cosy" in paths:
        cosy = phase_cosy_main(dev, card, float("nan"))
        out.update(cosy_ttfa_ms=cosy["ttfa_ms"], cosy_rtf=cosy["rtf"],
                   cosy_lm_ms_per_token=cosy["lm_ms_per_token"])
    if "serve" in paths:
        out["serve_tok_per_s"] = phase_serve_main(dev, card)["tok_per_s"]
    print(f"{what}: " + json.dumps(out))
    return out


def spark_wav_of_tree(what: str = "spark wav") -> dict:
    """The text->wav route's numbers (phase 18, on phase 6's tokens) with
    whichever rwkvtts_torch is imported, without the kernel phases' checks;
    prints them as one JSON line."""
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = phase_spark_wav_main(dev, card, phase_main(dev, card, {}))
    print(f"{what}: " + json.dumps(out))
    return out


def cosy_zs_of_tree(what: str = "cosy zs") -> dict:
    """Phases 19-21 alone (the Cosy goldens, the small zero-shot and B=64
    checks against the CPU, the zero-shot route at the 1.5B pairing, Cosy
    B=64 at 2048 x 24) with whichever rwkvtts_torch is imported, TF32 off;
    prints their numbers as one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    phase_cosy_zs_small(dev)
    out = {"zs": phase_cosy_zs_main(dev, card), "b64": phase_cosy_b64(dev, card)}
    out["b64"].pop("by_kernel")
    print(f"{what}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# 7-8. WKV7 training kernels: forward + backward against autograd through the
# plain versions
# ---------------------------------------------------------------------------


def fused_inputs(g: torch.Generator, Bn: int, T: int, H: int, dtype):
    """r, w_raw, k_raw, v, a in the model's ranges (w_raw <= -0.5, a in (0, 1))
    and the five per-head parameters near their init values."""
    dev = g.device
    f = lambda *s: torch.randn(*s, generator=g, device=dev)
    r, k_raw, v = 0.4 * f(Bn, T, H, 64), 0.4 * f(Bn, T, H, 64), 0.4 * f(Bn, T, H, 64)
    w_raw = -0.5 - torch.nn.functional.softplus(f(Bn, T, H, 64))
    a = torch.sigmoid(f(Bn, T, H, 64))
    seq = [x.to(dtype).contiguous() for x in (r, w_raw, k_raw, v, a)]
    prm = [0.7 + 0.1 * f(H, 64), 1.0 + 0.05 * f(H, 64), -0.04 + 0.1 * f(H, 64),
           1.0 + 0.1 * f(H, 64), 0.05 * f(H, 64)]
    state = 0.3 * f(Bn, H, 64, 64)
    resets = torch.rand(Bn, T, generator=g, device=dev) < 0.05
    resets[0, 16] = resets[0, 37] = resets[0, 38] = True  # at a chunk boundary, mid-chunk, twice
    return seq, prm, state, resets


def grad_check(fn, plain, diff, rest, g: torch.Generator, tol: float,
               what: str) -> tuple[float, float, dict]:
    """Run fn and plain (plain on f32 copies) on the same inputs and upstream
    gradients; every output and every gradient within tol of max |plain|.
    Returns the largest absolute error of the outputs and of the
    gradients, and the relative error of each."""
    ins_k = [x.detach().clone().requires_grad_() for x in diff]
    ins_p = [x.detach().float().clone().requires_grad_() for x in diff]
    y_k, s_k = fn(*ins_k, *rest)
    y_p, s_p = plain(*ins_p, *rest)
    dy = torch.randn(y_p.shape, generator=g, device=y_p.device).to(y_k.dtype)
    ds = 0.1 * torch.randn(s_p.shape, generator=g, device=s_p.device)
    gk = torch.autograd.grad((y_k, s_k), ins_k, (dy, ds))
    gp = torch.autograd.grad((y_p, s_p), ins_p, (dy.float(), ds))
    check(s_k.dtype == torch.float32 and all(a.dtype == x.dtype for a, x in zip(gk, ins_k)),
          f"{what}: the final state is not f32 or a gradient not in its input's dtype")
    worst, err, rels = 0.0, {"out": 0.0, "grad": 0.0}, {}
    for name, a, b in [("y", y_k, y_p), ("state", s_k, s_p)] + [
            (f"d{i}", a, b) for i, (a, b) in enumerate(zip(gk, gp))]:
        e = rels[name] = rel(a, b)
        worst = max(worst, e)
        kind = "grad" if name.startswith("d") else "out"
        err[kind] = max(err[kind], max_abs(a, b))
        check(e <= tol, f"{what}: {name} rel {e:.3e} > {tol:g}")
    print(f"{what}: outputs and {len(gk)} gradients, worst rel {worst:.3e} (limit {tol:g})")
    return err["out"], err["grad"], rels


def time_fwd_bwd(fn, diff, rest, reps: int):
    """(forward ms with the training save, backward ms) of fn on CUDA events:
    the backward is autograd.grad over a retained graph."""
    ins = [x.detach().clone().requires_grad_() for x in diff]
    fwd = cuda_ms(lambda: fn(*ins, *rest), reps)
    y, s = fn(*ins, *rest)
    dy, ds = torch.ones_like(y), torch.zeros_like(s)
    bwd = cuda_ms(lambda: torch.autograd.grad((y, s), ins, (dy, ds), retain_graph=True), reps)
    return fwd, bwd


def train_shape_bytes(seq, n_seq: int, entry_states: bool = True) -> int:
    """Bytes one training-shape WKV7 call must move: n_seq sequence tensors
    like seq[0], (B, T, H, 64) (inputs, outputs, upstream gradients), the
    f32 chunk-entry states every 16 steps where the call writes or reads
    them, and the initial or final state. The port's own per-step saves
    (sa, xhat, stats) are not counted: the function does not need them."""
    Bn, T, H, _ = seq[0].shape
    states = -(-T // 16) + 1 if entry_states else 1
    return n_seq * seq[0].numel() * seq[0].element_size() + states * Bn * H * 4096 * 4


def phase_wkv7_train(dev) -> tuple[dict, dict]:
    from rwkvtts_torch import _build
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops.wkv7 import wkv7_scan

    lib = _build.library()
    for T in (1, 200, TRAIN_T):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            plan = wkv7_cuda.bwd_plan(TRAIN_B, T, TRAIN_H, dtype)
            print(f"wkv7 train: backward plan T={T} {str(dtype)[6:]}: {plan}")
            check(lib.wkv7_bwd_smem_bytes(code) == plan["smem_bytes"],
                  "wkv7 backward plan: shared memory bytes differ from the library's")
    g = torch.Generator(device=dev).manual_seed(7)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        ins, state, resets = wkv_inputs(g, 2, 200, 4, dtype)
        resets[0, 16] = resets[0, 37] = resets[0, 38] = True
        grad_check(wkv7_cuda.wkv7, wkv7_scan, ins + [state], [resets], g, tol,
                   f"wkv7 train: {str(dtype)[6:]} B=2 T=200 H=4 state+resets")
    # every w_raw at -0.5, the fastest decay the model's clamp allows
    ins, state, resets = wkv_inputs(g, 2, 200, 4, torch.float32)
    ins[1] = torch.full_like(ins[1], -0.5)
    resets[0, 16] = resets[0, 37] = resets[0, 38] = True
    *_, minus_half = grad_check(wkv7_cuda.wkv7, wkv7_scan, ins + [state], [resets], g, 1e-4,
                                "wkv7 train: f32 B=2 T=200 H=4 state+resets, every w_raw -0.5")

    # the training shape, bf16, no state, no resets (padded batches)
    ins, _, _ = wkv_inputs(g, TRAIN_B, TRAIN_T, TRAIN_H, torch.bfloat16)
    _, err, _ = grad_check(wkv7_cuda.wkv7, wkv7_scan, ins, [], g, 2e-2,
                     f"wkv7 train: bf16 B={TRAIN_B} T={TRAIN_T} H={TRAIN_H}")
    # deterministic: two calls on the same inputs give the same bits
    runs = []
    dy = torch.randn(ins[0].shape, generator=g, device=dev).to(torch.bfloat16)
    ds = torch.randn(TRAIN_B, TRAIN_H, 64, 64, generator=g, device=dev)
    for _ in range(2):
        x = [t.detach().clone().requires_grad_() for t in ins]
        y, s = wkv7_cuda.wkv7(*x)
        runs.append([y, s, *torch.autograd.grad((y, s), x, (dy, ds))])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"wkv7 train: two calls on the same inputs, outputs and gradients bit-identical: "
          f"{same}")
    check(same, "wkv7 training kernels are not deterministic")
    fwd, bwd = time_fwd_bwd(wkv7_cuda.wkv7, ins, [], 5)
    p_fwd, p_bwd = time_fwd_bwd(wkv7_scan, [x.float() for x in ins], [], 1)
    steps = TRAIN_B * TRAIN_T * TRAIN_H
    # forward as wkv7_fwd (9 FLOP an element), reading 6 sequences and
    # writing y and the entry states; backward: ~22 FLOP an element (the
    # step-by-step form's count, kept so that the rows stay comparable),
    # reading 6 sequences, dy and the entry states, writing 6 gradients;
    # TF32 on the tensor cores, as both kernels compute
    f_bound = bound_ms(train_shape_bytes(ins, 7), 9 * 4096 * steps, TF32_TC_FLOPS)
    b_bound = bound_ms(train_shape_bytes(ins, 13), 22 * 4096 * steps, TF32_TC_FLOPS)
    print(f"wkv7 train: bf16 ({TRAIN_B}, {TRAIN_T}, {TRAIN_H}): forward {fwd:.4f} ms, "
          f"backward {bwd:.4f} ms; plain {p_fwd:.4f} / {p_bwd:.4f} ms; bounds "
          f"{f_bound[0]:.4f} ({f_bound[1]}) / {b_bound[0]:.4f} ms ({b_bound[1]})")
    row = {"name": "wkv7_bwd", "route": "cuda", "source": WKV7_BWD_SOURCE,
           "replaces": WKV7_BWD_REPLACES, "max_abs_err": err, "ms": bwd,
           "plain_ms": p_bwd, "bound_ms": b_bound[0], "bound_by": b_bound[1],
           "library_ms": None, "rel_err_w_raw_minus_half": minus_half}
    return row, {"train_fwd_ms": fwd, "train_fwd_plain_ms": p_fwd,
                 "train_fwd_bound_ms": f_bound[0]}


# chunk_kernel_bits on an NVIDIA H100: the bits of kernels 3-5 as they were
# redesigned; a change meant to move them records the new ones here
CHUNK_KERNEL_BITS = {
    "wkv7_bwd float32": "35e63fee079dcfa0", "wkv7_fused_fwd float32": "3bd4bafe8d189b7e",
    "wkv7_fused_bwd float32": "497eb0185320e25f", "wkv7_bwd bfloat16": "382dfc79b40ba5d4",
    "wkv7_fused_fwd bfloat16": "ae9835f1be593181", "wkv7_fused_bwd bfloat16": "b9a9983596b03b81"}


def hashed(shape, salt: int, lo: float, hi: float, dev) -> torch.Tensor:
    """f32 values in [lo, hi) from an integer hash of each element's index
    and `salt`: integer arithmetic and exact float steps, so the same bits
    on any machine and with any torch version."""
    i = torch.arange(math.prod(shape), dtype=torch.int64)
    h = (i * 2654435761 + salt * 97531 + 12345) % 2**32
    h = ((h ^ (h >> 15)) * 73244475) % 2**32
    u = (h ^ (h >> 13)).double() / 2**32
    return (lo + (hi - lo) * u).float().reshape(shape).to(dev)


def chunk_kernel_bits(dev) -> dict:
    """The first 16 hex digits of the sha256 of what kernels 3, 4 and 5
    write, called through their C entries on fixed inputs (`hashed`; B=2,
    T=200, H=4, bf16 and f32, a state, resets at a chunk boundary, mid-chunk
    and twice in a row; kernel 3 fed fixed anchors, kernel 5 kernel 4's).
    Their shared chunk machinery (csrc/wkv7_chunk.cuh) serves kernel 2
    too: a change made for it must leave these bits as they were
    (CHUNK_KERNEL_BITS). From the root of another checkout, with this file
    copied there, it gives that tree's bits."""
    import hashlib

    from rwkvtts_torch.ops import wkv7_cuda

    Bn, T, H = 2, 200, 4
    P = wkv7_cuda._ptr
    state = hashed((Bn, H, 64, 64), 13, -0.3, 0.3, dev)
    anchors = hashed((Bn, H, -(-T // 16), 64, 64), 14, -0.3, 0.3, dev)
    dsfin = hashed((Bn, H, 64, 64), 16, -0.1, 0.1, dev)
    prm = [hashed((H, 64), 8 + i, lo, hi, dev) for i, (lo, hi) in enumerate(
        ((0.6, 0.8), (0.9, 1.1), (-0.1, 0.1), (0.9, 1.1), (-0.05, 0.05)))]
    resets = torch.zeros(Bn, T, dtype=torch.bool, device=dev)
    resets[0, 16] = resets[0, 37] = resets[0, 38] = resets[1, 100] = True
    out = {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        seq = lambda salt, lo, hi: hashed((Bn, T, H, 64), salt, lo, hi, dev).to(dtype)
        r, k, v, w_raw = seq(1, -1, 1), seq(2, -0.5, 0.5), seq(3, -1, 1), seq(4, -3, -0.5)
        z, b, a, dy = seq(5, -0.125, 0), seq(6, 0, 0.125), seq(7, 0, 1), seq(15, -1, 1)
        g3 = [torch.empty_like(x) for x in (r, w_raw, k, v, z, b, state)]
        wkv7_cuda._launch("wkv7_bwd", r, code, Bn, T, H, *map(P, (
            r, w_raw, k, v, z, b, state, resets, anchors, dy, dsfin, *g3)))
        f4 = [torch.empty_like(x) for x in (v, state, anchors, v, state)]
        wkv7_cuda._launch("wkv7_fused_fwd", r, code, Bn, T, H, 64e-5, *map(P, (
            r, w_raw, k, v, a, *prm, state, resets, *f4[:3])))
        wkv7_cuda._launch("wkv7_fused_fwd", r, code, Bn, T, H, 64e-5, *map(P, (
            r, w_raw, k, v, a, *prm, state, resets, *f4[3:], None)))
        g5 = [torch.empty_like(x) for x in (r, w_raw, k, v, a)]
        g5 += [torch.empty(5, Bn, H, 64, device=dev), torch.empty_like(state)]
        wkv7_cuda._launch("wkv7_fused_bwd", r, code, Bn, T, H, 64e-5, *map(P, (
            r, w_raw, k, v, a, *prm[:4], state, resets, f4[2], dy, dsfin, *g5)))
        torch.cuda.synchronize()
        for name, ts in (("wkv7_bwd", g3), ("wkv7_fused_fwd", f4), ("wkv7_fused_bwd", g5)):
            hsh = hashlib.sha256()
            for t in ts:
                hsh.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            out[f"{name} {str(dtype)[6:]}"] = hsh.hexdigest()[:16]
    return out


def queued_ms(fn, reps: int) -> tuple[float, int]:
    """Mean device milliseconds a call of fn after one warm call, and the
    calls of fn made in all: CUDA events around `reps` calls enqueued behind
    a sleeping kernel (QUEUE_SLEEP_CYCLES), so the card runs the calls'
    kernels back to back and the window holds none of the host's time. A
    window that the card reached before the host had issued every call (the
    host held up: another thread, a collection) is thrown away and taken
    again behind a sleep four times as long, at most QUEUE_SLEEP_TRIES
    windows in all; fails if the last one was reached early too."""
    import threading

    fn()
    torch.cuda.synchronize()
    calls, cycles = 1, QUEUE_SLEEP_CYCLES
    for _ in range(QUEUE_SLEEP_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        calls += reps
        early = start.query()
        end.synchronize()
        if not early:
            return start.elapsed_time(end) / reps, calls
        print(f"queued_ms: the card reached the window before the host had issued {reps} calls "
              f"behind {cycles} cycles of sleep (live threads: "
              f"{[t.name for t in threading.enumerate()]}); taking it again behind {4 * cycles}")
        cycles *= 4
    check(False, f"queued_ms: the sleep ended before every call was issued in "
                 f"{QUEUE_SLEEP_TRIES} windows")


def fused_times(seq, prm, reps: int = 5, device: bool = False) -> dict:
    """Milliseconds of wkv7_fused on the card: the forward that saves for
    the backward (`fwd_save`), the primal forward under no_grad
    (`fwd_primal`) and the backward (`bwd`: autograd.grad over a retained
    graph, dy and the zero final-state gradient made before). On CUDA
    events around the calls (`<name>_ms`, the host's time in where it is
    longer); with `device`, on CUDA events behind a queued sleep
    (`<name>_device_ms`, queued_ms), the calls checked to launch their
    kernel once each and no other kernel of wkv7_cuda (the backward's
    window also holds the wrapper's sum of the per-head gradients over the
    batch, one small reduction)."""
    from rwkvtts_torch.ops import wkv7_cuda

    ins = [x.detach().clone().requires_grad_() for x in seq + prm]
    y, st = wkv7_cuda.wkv7_fused(*ins)
    dy, ds = torch.ones_like(y), torch.zeros_like(st)

    def primal():
        with torch.no_grad():
            wkv7_cuda.wkv7_fused(*seq, *prm)

    calls = {"fwd_save": (lambda: wkv7_cuda.wkv7_fused(*ins), "wkv7_fused_fwd"),
             "fwd_primal": (primal, "wkv7_fused_fwd"),
             "bwd": (lambda: torch.autograd.grad((y, st), ins, (dy, ds), retain_graph=True),
                     "wkv7_fused_bwd")}
    out = {}
    for name, (fn, kernel) in calls.items():
        if not device:
            out[f"{name}_ms"] = cuda_ms(fn, reps)
            continue
        before = dict(wkv7_cuda.launches)
        out[f"{name}_device_ms"], calls = queued_ms(fn, reps)
        got = {k: n - before[k] for k, n in wkv7_cuda.launches.items() if n != before[k]}
        check(got == {kernel: calls}, f"fused times: {name}'s {calls} calls launched {got}")
    return out


def fused_times_of_tree(what: str = "fused") -> dict:
    """fused_times at the training shape (8, 2048, 16), bf16, on phase 8's
    inputs (seed 8), with whichever rwkvtts_torch is imported: from the root
    of another checkout, with this file copied there, it times that tree's
    kernels under the same measurement, e.g. the parent's."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    seq, prm, _, _ = fused_inputs(g, TRAIN_B, TRAIN_T, TRAIN_H, torch.bfloat16)
    times = fused_times(seq, prm)
    print(f"{what}: bf16 ({TRAIN_B}, {TRAIN_T}, {TRAIN_H}): forward {times['fwd_save_ms']:.4f} ms "
          f"saving, {times['fwd_primal_ms']:.4f} ms primal; backward {times['bwd_ms']:.4f} ms")
    return times


def phase_wkv7_fused(dev) -> tuple[dict, dict]:
    from rwkvtts_torch import _build
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops.wkv7 import wkv7_fused_plain

    lib = _build.library()
    for T in (1, 200, TRAIN_T):
        plan = wkv7_cuda.fused_plan(TRAIN_B, T, TRAIN_H)
        print(f"wkv7 fused: plan T={T}: {plan}")
        check(lib.wkv7_fused_smem_bytes(0) == plan["fwd_smem_bytes"]
              and lib.wkv7_fused_smem_bytes(1) == plan["bwd_smem_bytes"],
              "wkv7 fused plan: shared memory bytes differ from the library's")
    g = torch.Generator(device=dev).manual_seed(8)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        seq, prm, state, resets = fused_inputs(g, 2, 200, 4, dtype)
        grad_check(wkv7_cuda.wkv7_fused, wkv7_fused_plain, seq + prm + [state], [resets],
                   g, tol, f"wkv7 fused: {str(dtype)[6:]} B=2 T=200 H=4 state+resets")
    # every w_raw at -0.5, the fastest decay the model's clamp allows
    seq, prm, state, resets = fused_inputs(g, 2, 200, 4, torch.float32)
    seq[1] = torch.full_like(seq[1], -0.5)
    grad_check(wkv7_cuda.wkv7_fused, wkv7_fused_plain, seq + prm + [state], [resets], g, 1e-4,
               "wkv7 fused: f32 B=2 T=200 H=4 state+resets, every w_raw -0.5")

    seq, prm, _, _ = fused_inputs(g, TRAIN_B, TRAIN_T, TRAIN_H, torch.bfloat16)
    out_err, grad_err, _ = grad_check(wkv7_cuda.wkv7_fused, wkv7_fused_plain, seq + prm, [], g,
                                      2e-2, f"wkv7 fused: bf16 B={TRAIN_B} T={TRAIN_T} H={TRAIN_H}")
    # deterministic: two calls on the same inputs give the same bits
    runs = []
    dy = torch.randn(seq[0].shape, generator=g, device=dev).to(torch.bfloat16)
    ds = torch.randn(TRAIN_B, TRAIN_H, 64, 64, generator=g, device=dev)
    for _ in range(2):
        ins = [x.detach().clone().requires_grad_() for x in seq + prm]
        y, s = wkv7_cuda.wkv7_fused(*ins)
        runs.append([y, s, *torch.autograd.grad((y, s), ins, (dy, ds))])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"wkv7 fused: two calls on the same inputs, outputs and gradients bit-identical: {same}")
    check(same, "wkv7 fused kernels are not deterministic")
    bits = chunk_kernel_bits(dev)
    kept = bits == CHUNK_KERNEL_BITS
    print(f"wkv7 fused: kernels 3-5 on fixed inputs give the recorded bits: {kept} {bits}")
    check(kept, "kernels 3-5 changed their bits (CHUNK_KERNEL_BITS)")
    times = fused_times(seq, prm)
    p_fwd, p_bwd = time_fwd_bwd(wkv7_fused_plain, [x.float() for x in seq + prm], [], 1)
    f_bound, p_bound, b_bound = fused_bounds(seq)
    fwd, bwd = times["fwd_save_ms"], times["bwd_ms"]
    print(f"wkv7 fused: bf16 ({TRAIN_B}, {TRAIN_T}, {TRAIN_H}): forward {fwd:.4f} ms saving, "
          f"{times['fwd_primal_ms']:.4f} ms primal; backward {bwd:.4f} ms; plain {p_fwd:.4f} / "
          f"{p_bwd:.4f} ms; bounds {f_bound[0]:.4f} ({f_bound[1]}) saving, {p_bound[0]:.4f} "
          f"({p_bound[1]}) primal / {b_bound[0]:.4f} ms ({b_bound[1]})")
    common = {"route": "cuda", "source": FUSED_SOURCE, "library_ms": None}
    return ({"name": "wkv7_fused_fwd", "replaces": FUSED_FWD_REPLACES, "max_abs_err": out_err,
             "ms": fwd, "ms_primal": times["fwd_primal_ms"], "plain_ms": p_fwd,
             "bound_ms": f_bound[0], "bound_by": f_bound[1], "primal_bound_ms": p_bound[0],
             "primal_bound_by": p_bound[1], **common},
            {"name": "wkv7_fused_bwd", "replaces": FUSED_BWD_REPLACES, "max_abs_err": grad_err,
             "ms": bwd, "plain_ms": p_bwd, "bound_ms": b_bound[0], "bound_by": b_bound[1],
             **common})


# ---------------------------------------------------------------------------
# 9. One small train step: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------


def synthetic_rows(seed: int, n: int, T: int):
    """n rows {text, global_tokens, semantic_tokens} whose Spark layout
    fills exactly T positions: random text, 32 global tokens in [0, 4096),
    semantic tokens in [0, 8192)."""
    import numpy as np

    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    tok = get_world_tokenizer()
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    rows = []
    for _ in range(n):
        n_words = rng.integers(2, max(3, min(40, T // 8)))  # at most ~T/2 text tokens
        words = ["".join(rng.choice(letters, rng.integers(2, 9))) for _ in range(n_words)]
        text = " ".join(words)
        n_sem = T - 36 - len(tok.encode(text))  # 3 tags, 32 globals, EOS
        rows.append({"text": text, "global_tokens": rng.integers(0, 4096, 32).tolist(),
                     "semantic_tokens": rng.integers(0, 8192, n_sem).tolist()})
    return rows


def phase_train_small(dev) -> None:
    import functools

    from rwkvtts_torch.data import spark_collator as sc
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.parallel import train_step as ts
    from rwkvtts_torch.train import optimizer as opt_lib
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    collate = functools.partial(sc.collate_plain, tokenizer=get_world_tokenizer(),
                                eos_id=8192, pad_to=256)
    for fuse in (True, False):
        for packed in (False, True):
            cfg = spark.default_config(hidden_size=256, num_layers=2, dtype=torch.float32,
                                       wkv_fuse_prep=fuse)
            params = spark.init_params(torch.Generator().manual_seed(9), cfg)
            randomize(params, torch.Generator().manual_seed(10))
            rows = synthetic_rows(11, 2, 120)
            batch = {k: torch.as_tensor(v) for k, v in collate(rows, packed=packed).items()}
            out = {}
            for where in ("cpu", dev):
                p = rwkv7.tree_map(lambda t: t.to(where).clone(), params)
                opt = opt_lib.AdamW(p, warmup_steps=0)
                step = ts.make_train_step(cfg, opt)
                _, m = step(ts.init_train_state(p, opt),
                            {k: v.to(where) for k, v in batch.items()}, None)
                out[str(where)] = (m["loss"].item(), m["grad_norm"].item())
            (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
            el, eg = abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc)
            print(f"train small: hidden 256 x 2, f32, fuse_prep={fuse}, packed={packed}: "
                  f"loss {lg:.6f} vs {lc:.6f} (rel {el:.2e}, limit 1e-4), grad norm "
                  f"{gg:.6f} vs {gc:.6f} (rel {eg:.2e}, limit 1e-3)")
            check(el <= 1e-4 and eg <= 1e-3, "small train step disagrees with the CPU")


# ---------------------------------------------------------------------------
# 10. Training main path, through the train CLI
# ---------------------------------------------------------------------------


def _cli_args(dev, data: str, run_dir: str, layers: int, extra=()):
    return ["--task", "spark", "--data", data, "--run-dir", run_dir, "--device", str(dev),
            "--hidden", str(TRAIN_H * 64), "--layers", str(layers), "--batch-size",
            str(TRAIN_B), "--pad-to", str(TRAIN_T), "--log-every", "1", "--save-steps", "0",
            *extra]


def phase_train_main(dev, card: str) -> dict:
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.train import cli

    L = TRAIN_LAYERS
    n_steps = TRAIN_WARM + TRAIN_TIMED
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "rows.jsonl")
        with open(data, "w") as f:
            for row in synthetic_rows(12, TRAIN_B * n_steps, TRAIN_T):
                f.write(json.dumps(row) + "\n")
        run_dir = os.path.join(tmp, "run")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wkv7_cuda.reset_launches()
        tr = cli.main(_cli_args(dev, data, run_dir, L))
        torch.cuda.synchronize()
        launches = dict(wkv7_cuda.launches)
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]

        check(len(recs) == n_steps, f"{len(recs)} logged steps, want {n_steps}")
        losses = [r["loss"] for r in recs]
        check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
        check(abs(losses[0] - math.log(8193)) <= 0.5,
              f"first loss {losses[0]:.4f} not within 0.5 of ln 8193")
        check(sum(r["skipped"] for r in recs) == 0, "a step was skipped")
        check(launches["wkv7_fused_fwd"] == 2 * L * n_steps
              and launches["wkv7_fused_bwd"] == L * n_steps,
              f"fused launches {launches}, want {2 * L} and {L} a step")
        # step k's metrics are read after step k+1 is issued, so the time
        # stamp of log k marks the end of step k+1: the span between the logs
        # of the warm-up's end and of the second-to-last step covers the
        # steps in between, each issued while the device ran the one before
        t = [r["time"] for r in recs]
        timed = n_steps - 1 - TRAIN_WARM
        step_s = (t[n_steps - 2] - t[TRAIN_WARM - 1]) / timed
        tps = TRAIN_B * TRAIN_T / step_s
        print(f"train main: Spark {TRAIN_H * 64} x {L}, B={TRAIN_B} x {TRAIN_T}, bf16, fused prep, "
              f"remat: losses {[round(x, 4) for x in losses]}")
        print(f"train main: {1e3 * step_s:.2f} ms a step over {timed} steps, {tps:.1f} "
              f"tokens/s, peak memory {peak / 2**30:.2f} GiB on {card}; launches a step "
              f"{ {k: v / n_steps for k, v in launches.items()} }")

        remat = remat_runs(dev, card, data, tmp, L)

        # the WKV kernels' share of the device time of two more steps
        batches = list(tr_batches(tr, data, 2))
        share = profile_share(tr, batches)

        # the unfused path, 1024 hidden at fewer layers; ms a step as above,
        # over the steps after the first two
        L_u, n_u = 4, 4
        wkv7_cuda.reset_launches()
        u_dir = os.path.join(tmp, "run_unfused")
        cli.main(_cli_args(dev, data, u_dir, L_u,
                           ("--no-wkv-fuse-prep", "--max-rows", str(TRAIN_B * n_u))))
        torch.cuda.synchronize()
        unfused = dict(wkv7_cuda.launches)
        with open(os.path.join(u_dir, "metrics.jsonl")) as f:
            t_u = [json.loads(line)["time"] for line in f]
        u_step_ms = 1e3 * (t_u[n_u - 2] - t_u[0]) / (n_u - 2)
        print(f"train main: unfused path, {TRAIN_H * 64} x {L_u}, {n_u} steps: launches {unfused}, "
              f"{u_step_ms:.2f} ms a step")
        check(unfused["wkv7_fwd"] == 2 * L_u * n_u and unfused["wkv7_bwd"] == L_u * n_u
              and unfused["wkv7_fused_fwd"] == 0,
              f"unfused launches {unfused}, want {2 * L_u} and {L_u} a step")
    return {"launches": launches, "unfused": unfused, "step_ms": 1e3 * step_s,
            "tokens_per_s": tps, "peak_gib": peak / 2**30, "unfused_step_ms": u_step_ms,
            "remat": remat, **share}


def remat_runs(dev, card: str, data: str, tmp: str, L: int) -> dict:
    """Phase 10's run at 1 + REMAT_TIMED steps (its first rows) under the
    default full replay and under each of REMAT_RUNS (--remat-policy):
    kernels 4 / 5 launch L / L times a step under "wkv" (the replay keeps
    the WKV call), 2 L / L under "dots"; each first loss equals the
    default's (the same forward on the same batch and seed); ms a step over
    the timed steps as phase 10 reads it, peak memory."""
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.train import cli

    n_steps = 1 + REMAT_TIMED
    out = {}
    for policy in (None,) + REMAT_RUNS:
        run_dir = os.path.join(tmp, f"run_remat_{policy}")
        extra = ("--max-rows", str(TRAIN_B * n_steps))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wkv7_cuda.reset_launches()
        cli.main(_cli_args(dev, data, run_dir, L,
                           extra + (("--remat-policy", policy) if policy else ())))
        torch.cuda.synchronize()
        launches = {k: wkv7_cuda.launches[k] / n_steps for k in ("wkv7_fused_fwd",
                                                                 "wkv7_fused_bwd")}
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        t = [r["time"] for r in recs]
        # log k's time stamp marks the end of step k + 1 (phase 10)
        step_ms = 1e3 * (t[n_steps - 2] - t[0]) / (n_steps - 2)
        name = policy or "default"
        out[name] = {"launches_a_step": launches, "step_ms": step_ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "losses": [r["loss"] for r in recs]}
        first, default = recs[0]["loss"], out["default"]["losses"][0]
        want = (L if policy == "wkv" else 2 * L, L)
        print(f"train main: remat {name}, 1 + {REMAT_TIMED} steps: {step_ms:.2f} ms a step, "
              f"peak memory {out[name]['peak_gib']:.2f} GiB, fused launches a step {launches} "
              f"(want {want}), first loss {first!r} (the default's {default!r}) on {card}")
        check((launches["wkv7_fused_fwd"], launches["wkv7_fused_bwd"]) == want,
              f"train main: remat {name} launches {launches}")
        check(abs(first - default) <= 1e-6 * abs(default),
              f"train main: remat {name}: first loss {first} != {default}")
        check(len(recs) == n_steps and all(math.isfinite(r["loss"]) and not r["skipped"]
                                           for r in recs),
              f"train main: remat {name}: {len(recs)} steps, a non-finite or skipped one")
    return out


def tr_batches(tr, data: str, n: int):
    """n collated batches of the main run's data, on the trainer's device."""
    import functools

    from rwkvtts_torch.data import jsonl_dataset, spark_collator as sc
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    collate = functools.partial(sc.collate_plain, tokenizer=get_world_tokenizer(),
                                eos_id=8192, pad_to=TRAIN_T)
    ds = jsonl_dataset.JsonlDataset(jsonl_dataset.load_jsonl_rows([data]), collate, TRAIN_B)
    for _, batch in zip(range(n), ds.epoch(1)):
        yield tr.to_device(batch)


def profile_share(tr, batches) -> dict:
    """Device time of the WKV kernels over all kernels' device time in
    train steps under torch.profiler (None where the trace has none)."""
    from torch.profiler import ProfilerActivity, profile

    state = tr.state
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, m = tr.step_fn(state, batch, tr.generator)
        m["loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr.state = state
    by_kernel = kernel_totals(prof)
    total = sum(t for t, _ in by_kernel.values())
    wkv = sum(t for k, (t, _) in by_kernel.items() if "wkv7_" in k)
    if total <= 0:
        print("train main: torch.profiler recorded no device time: WKV share not measured")
        return {"wkv_share": None}
    busy = total / 1e6 / wall
    print(f"train main: profiled {len(batches)} steps: wall {wall:.4f} s, device busy "
          f"{total / 1e6:.4f} s ({busy:.3f}); WKV kernels {wkv / 1e6:.4f} s = "
          f"{wkv / total:.3f} of device time")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"train main:   {t / 1e3 / len(batches):9.3f} ms a step, {n // len(batches):5d} "
              f"launches  {name[:110]}")
    return {"wkv_share": wkv / total, "busy": busy, "wall_s": wall}


# ---------------------------------------------------------------------------
# 11. B=1 decode step (the Cosy streaming LM step)
# ---------------------------------------------------------------------------


def b1_setup(dev):
    """The B=1 step's config and pack at 2048 x 24, random weights from
    seed 13 (loras, output and FFN value nonzero), and its generator."""
    from rwkvtts_torch.models import rwkv7
    from rwkvtts_torch.ops import decode_mega as dm

    cfg = rwkv7.RWKV7Config(vocab_size=0, hidden_size=COSY_C, num_layers=COSY_L)
    g = torch.Generator(device=dev).manual_seed(13)
    params = rwkv7.init_params(g, cfg)
    randomize(params, g)
    return cfg, dm.pack_mega(params, cfg), g


def b1_state(g: torch.Generator, cfg, carry):
    L, C, H = cfg.num_layers, cfg.hidden_size, cfg.num_heads
    f = lambda *shape, s: s * torch.randn(*shape, generator=g, device=g.device)
    return {"att_x": f(L, 1, C, s=0.5), "wkv": f(L, 1, H, 64, 64, s=0.1).to(carry),
            "ffn_x": f(L, 1, C, s=0.5)}


def b1_profile(what: str, mega, cfg, x, state) -> dict:
    """The B=1 step's ms (CUDA events, 20 steps, with whichever launch
    options the imported kernel has), then its device time by kernel
    without programmatic dependent launch where the wrapper can turn it off
    (a span then holds only its kernel's own work), and the GEMVs' rate:
    the packed bytes each product reads a step over its device time."""
    import inspect
    import re

    from rwkvtts_torch.ops import decode_mega as dm

    step = lambda **kw: dm.decode_step_mega(mega, cfg, x, state, **kw)
    ms = cuda_ms(step, 20)
    nopdl = "pdl" in inspect.signature(dm.decode_step_mega).parameters
    prof = step_profile(what, (lambda: step(pdl=False)) if nopdl else step,
                        cuda_ms(lambda: step(pdl=False), 20) if nopdl else ms)
    # bytes a step of each product the GEMV kernels run (packed weights and
    # scales); a tree whose kernel runs the lora-out in its glue (PRODUCTS
    # without "lo") counts it there, not here
    kinds = {"rkv_li": ("rkv_q", "rkv_s", "li_q", "li_s"), "lo": ("lo",),
             "out": ("out_q", "out_s"), "fk": ("fk_q", "fk_s"), "fv": ("fv_q", "fv_s")}
    products = getattr(dm, "PRODUCTS", None)
    kind_bytes = {k: nbytes(*(mega[n] for n in names)) for k, names in kinds.items()
                  if products is None or k in products}
    gemv_ms = sum(t for n, t in prof["by_kernel_ms"].items() if "gemv" in n)
    rates = {"all": sum(kind_bytes.values()) / gemv_ms / 1e6}
    for name, t in prof["by_kernel_ms"].items():
        m = re.search(r"gemv_kernel<(\d)>", name)
        if m and products:
            rates[products[int(m.group(1))]] = kind_bytes[products[int(m.group(1))]] / t / 1e6
    print(f"{what}: {ms:.4f} ms a step with the kernel's launch options"
          + (f", {prof['host_ms']:.4f} ms without programmatic dependent launch" if nopdl else "")
          + f"; GEMVs {gemv_ms:.4f} ms of device time a step, GB/s "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    return {"ms": ms, **prof, "gemv_ms": gemv_ms, "gemv_gbps": rates}


def decode_b1_profile_of_tree(what: str = "decode b1") -> dict:
    """b1_profile at 2048 x 24 (phase 11's weights, bf16 carry) with
    whichever rwkvtts_torch is imported: from the root of another checkout,
    with this file copied there, it measures that tree's kernel the same
    way, e.g. the parent's."""
    dev = torch.device("cuda", 0)
    cfg, mega, g = b1_setup(dev)
    state = b1_state(g, cfg, torch.bfloat16)
    x = torch.randn(1, cfg.hidden_size, generator=g, device=dev)
    return b1_profile(what, mega, cfg, x, state)


def phase_decode_b1(dev) -> tuple[dict, dict, float]:
    from rwkvtts_torch import _build
    from rwkvtts_torch.ops import decode_mega as dm

    lib = _build.library()
    for C in (1024, COSY_C):
        plan = dm.launch_plan(C)
        for name, pr in plan["products"].items():
            print(f"decode b1: plan C={C} {name}: {pr}")
            check(lib.decode_b1_smem_bytes(pr["tile_bytes"], pr["k_piece"]) == pr["smem_bytes"]
                  <= dm.SMEM_LIMIT, f"decode b1 plan {name}: shared memory")
        check(lib.decode_b1_smem_bytes(0, 0) == plan["glue_smem_bytes"] <= dm.SMEM_LIMIT,
              "decode b1 plan: the glue's shared memory")
        check(lib.decode_b1_workspace_bytes(C) == plan["workspace_bytes"],
              "decode b1 plan: workspace bytes")
    cfg, mega, g = b1_setup(dev)
    L, C = cfg.num_layers, cfg.hidden_size
    err = 0.0
    for carry in (torch.bfloat16, torch.float32):
        st_k = b1_state(g, cfg, carry)
        st_p = {k: v.clone() for k, v in st_k.items()}
        for i in range(4):
            x = torch.randn(1, C, generator=g, device=dev)
            h_k, _ = dm.decode_step_mega(mega, cfg, x, st_k)
            h_p, _ = dm.decode_step_plain(mega, cfg, x, st_p)
            eh = rel(h_k, h_p)
            err = max(err, max_abs(h_k, h_p))
            check(bool(torch.isfinite(h_k).all()), "decode b1 hidden is not finite")
            check(eh <= 2e-2, f"decode b1 kernel disagrees with decode_step_plain: {eh:.3e}")
        leaves = {k: rel(st_k[k], st_p[k]) for k in ("att_x", "ffn_x", "wkv")}
        print(f"decode b1: {str(carry)[6:]} carry, 4 steps: hidden rel {eh:.3e} (last), state "
              + ", ".join(f"{k} {v:.3e}" for k, v in leaves.items()) + " (limit 2e-2)")
        check(max(leaves.values()) <= 2e-2, f"decode b1 state disagrees: {leaves}")
        # deterministic: two calls on the same inputs give the same bits
        runs = []
        for _ in range(2):
            st = {k: v.clone() for k, v in st_k.items()}
            h, _ = dm.decode_step_mega(mega, cfg, x, st)
            runs.append({"h": h, **st})
        same = {k: torch.equal(runs[0][k], runs[1][k]) for k in runs[0]}
        print(f"decode b1: {str(carry)[6:]} carry: two calls on the same inputs, bit-identical: "
              f"{same}")
        check(all(same.values()), "decode b1 step is not deterministic")

    st_k = b1_state(g, cfg, torch.bfloat16)
    st_p = {k: v.clone() for k, v in st_k.items()}
    dm.reset_launches()
    dm.decode_step_mega(mega, cfg, x, st_k)
    per_step = dict(dm.kernel_launches)
    want = dm.launches_per_step(L)
    check(per_step == want and dm.launches == sum(want.values()),
          f"decode b1 launches a step {per_step}, want {want}")
    prof = b1_profile("decode b1", mega, cfg, x, st_k)
    ms = prof["ms"]
    plain_ms = cuda_ms(lambda: dm.decode_step_plain(mega, cfg, x, st_p), 3)
    # bytes: every packed tensor once, the state read and written, x and h;
    # operations: 2 FLOP a weight on the CUDA cores (f32 FMA)
    weights = [t for t in mega.values() if torch.is_tensor(t)]
    n_w = sum(t.numel() for t in weights if t.dtype in (torch.int8, torch.bfloat16))
    bms, by = bound_ms(nbytes(*weights) + 2 * nbytes(*st_k.values()) + 2 * nbytes(x),
                       2 * n_w, F32_FLOPS)
    print(f"decode b1: C={C} L={L}, bf16 carry: {per_step} launches a step; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms a step, bound {bms:.4f} ms ({by}), "
          f"{nbytes(*weights) / 1e9:.4f} GB of packed weights")
    return ({"name": "decode_b1_step", "route": "cuda", "source": DECODE_B1_SOURCE,
             "replaces": DECODE_B1_REPLACES, "max_abs_err": err, "ms": ms,
             "ms_nopdl": prof["host_ms"], "device_ms_nopdl": prof["device_ms"],
             "device_ms_nopdl_by_kernel": prof["by_kernel_ms"], "gemv_gbps": prof["gemv_gbps"],
             "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None},
            per_step, ms)


# ---------------------------------------------------------------------------
# 12-13. Cosy streaming: small on card vs CPU, then the main path
# ---------------------------------------------------------------------------


class CharTok:
    """The streaming bench's character tokenizer
    (benchmarks/bench_streaming_latency.py:27-28)."""

    def encode(self, text):
        return [ord(c) % 6000 + 10 for c in text]


class _Tap:
    """Wraps module.name so every call's result goes to on_result(result,
    start, end), with CUDA events recorded around the call (no host
    synchronisation), and its arguments to .last; restores it on exit."""

    def __init__(self, module, name, on_result):
        self.module, self.name, self.on_result = module, name, on_result

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            self.last = (a, kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.on_result(out, start, end)
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def tiny_codecs():
    from rwkvtts_torch.codecs import conformer, flow, hift

    fcfg = flow.FlowConfig(
        input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562, n_timesteps=2,
        encoder=conformer.UpsampleConformerConfig(input_size=24, output_size=24,
                                                  attention_heads=2, linear_units=48,
                                                  num_blocks=1, num_up_blocks=1),
        estimator=flow.EstimatorConfig(in_channels=64, out_channels=16, channels=(16,),
                                       n_blocks=1, num_mid_blocks=1, num_heads=2,
                                       attention_head_dim=8, static_chunk_size=2))
    hcfg = hift.HiFTConfig(in_channels=16, base_channels=32, nb_harmonics=2,
                           upsample_rates=(4, 3), upsample_kernel_sizes=(8, 7), istft_n_fft=16,
                           istft_hop_len=4, resblock_kernel_sizes=(3,),
                           resblock_dilation_sizes=((1, 2),), source_resblock_kernel_sizes=(7, 7),
                           source_resblock_dilation_sizes=((1, 2), (1, 2)), f0_cond_channels=16)
    return (fcfg, flow.init_params(torch.Generator().manual_seed(21), fcfg),
            hcfg, hift.init_params(torch.Generator().manual_seed(22), hcfg))


def phase_cosy_small(dev) -> None:
    from rwkvtts_torch.infer import generate as gen
    from rwkvtts_torch.infer import streaming
    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import cosy

    cfg = cosy.default_config(hidden_size=256, num_layers=2)
    g = torch.Generator().manual_seed(23)
    params = cosy.init_params(g, cfg)
    randomize(params, g)
    params["head"] = 10.0 * params["head"]  # greedy gaps far above rounding noise
    fcfg, fparams, hcfg, hparams = tiny_codecs()
    scfg = streaming.StreamConfig(token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2,
                                  lm_chunk=4)
    out = {}
    for where in ("cpu", dev):
        pipe = CosyPipeline(cfg, params, CharTok(), fcfg, fparams, hcfg, hparams,
                            decode_megakernel=True, device=where)
        toks = []
        with _Tap(gen, "cosy_decode_chunk", lambda o, *_: toks.append(o[1].cpu())):
            wav = list(streaming.stream_synthesize(pipe, "hello streaming", stream_cfg=scfg,
                                                   seed=3, max_new_tokens=24, top_k=1))
        out[str(where)] = (torch.cat(toks, 1), wav)
    (t_cpu, w_cpu), (t_gpu, w_gpu) = out["cpu"], out[str(dev)]
    same = t_cpu.shape == t_gpu.shape and bool((t_cpu == t_gpu).all())
    n_cpu, n_gpu = sum(len(c) for c in w_cpu), sum(len(c) for c in w_gpu)
    finite = all(math.isfinite(float(abs(c).sum())) for c in w_gpu)
    print(f"cosy small: LM 256 x 2 bf16, tiny flow / HiFT, greedy, {t_gpu.shape[1]} tokens: "
          f"card vs CPU tokens identical {same}; {len(w_gpu)} / {len(w_cpu)} chunks, "
          f"{n_gpu} / {n_cpu} samples, finite {finite}")
    check(same, f"cosy small tokens differ: card {t_gpu.tolist()} cpu {t_cpu.tolist()}")
    check(finite and n_gpu == n_cpu and len(w_gpu) == len(w_cpu),
          "cosy small audio not finite or of another length")


def phase_cosy_main(dev, card: str, kernel_ms: float) -> dict:
    import numpy as np

    from rwkvtts_torch.codecs import flow, hift
    from rwkvtts_torch.infer import generate as gen
    from rwkvtts_torch.infer import streaming
    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import decode_mega as dm
    from rwkvtts_torch.ops import wkv7_cuda

    t0 = time.perf_counter()
    cfg = cosy.default_config(hidden_size=COSY_C, num_layers=COSY_L)
    params = cosy.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)
    fcfg, hcfg = flow.FlowConfig(), hift.HiFTConfig()
    pipe = CosyPipeline(cfg, params, CharTok(), fcfg,
                        flow.init_params(torch.Generator(device=dev).manual_seed(1), fcfg), hcfg,
                        hift.init_params(torch.Generator(device=dev).manual_seed(2), hcfg),
                        device=dev)
    del params
    torch.cuda.synchronize()
    print(f"cosy main: LM {COSY_C} x {COSY_L} bf16 + flow + HiFT (defaults) built and packed in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    requests = [dict(text="".join(rng.choice(letters, COSY_TEXT)),
                     prompt_speech_tokens=rng.integers(0, 6561, COSY_PROMPT).tolist(),
                     prompt_mel=rng.standard_normal((2 * COSY_PROMPT, 80)).astype(np.float32),
                     spk_embedding=rng.standard_normal(192).astype(np.float32))
                for _ in range(3)]
    up = hcfg.total_upsample
    want = COSY_NEW * fcfg.token_mel_ratio * up
    runs = []
    for i, req in enumerate(requests):
        stages = {"lm": [], "flow": [], "hift": []}
        n_tok = [0]

        def lm_done(out, start, end):
            stages["lm"].append((start, end))
            n_tok[0] += out[1].shape[1]

        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dm.reset_launches()
            wkv7_cuda.reset_launches()
        with _Tap(gen, "cosy_decode_chunk", lm_done), \
                _Tap(streaming, "_flow_hop", lambda o, s, e: stages["flow"].append((s, e))) \
                as flow_tap, \
                _Tap(streaming, "_hift_hop", lambda o, s, e: stages["hift"].append((s, e))) \
                as hift_tap:
            t0 = time.perf_counter()
            ttfa, chunks = None, []
            for chunk in streaming.stream_synthesize(pipe, stream_cfg=streaming.StreamConfig(),
                                                     seed=i, max_new_tokens=COSY_NEW, **req):
                if ttfa is None:
                    ttfa = time.perf_counter() - t0
                chunks.append(chunk)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in stages.items()}
        wav = np.concatenate(chunks)
        audio_s = len(wav) / pipe.sample_rate
        check(bool(np.isfinite(wav).all()), "cosy main audio is not finite")
        check(abs(len(wav) - want) <= hcfg.total_upsample * streaming.StreamConfig().mel_cache_len,
              f"cosy main: {len(wav)} samples, want {want} (400 tokens)")
        run = {"ttfa_ms": 1e3 * ttfa, "rtf": wall / audio_s, "audio_s": audio_s, "wall_s": wall,
               "chunks": len(chunks), "tokens_decoded": n_tok[0],
               "lm_ms_per_token": sum(ms["lm"]) / n_tok[0],
               "flow_ms_per_hop": sum(ms["flow"]) / len(ms["flow"]),
               "hift_ms_per_hop": sum(ms["hift"]) / len(ms["hift"]),
               "flow_hops": len(ms["flow"]), "hift_calls": len(ms["hift"])}
        print(f"cosy main: utterance {i} ({'warm-up' if i == 0 else 'timed'}): TTFA "
              f"{run['ttfa_ms']:.2f} ms, RTF {run['rtf']:.4f}, {audio_s:.3f} s of audio in "
              f"{wall:.3f} s, {len(chunks)} chunks; LM {run['lm_ms_per_token']:.4f} ms a token "
              f"({n_tok[0]} decoded), flow {run['flow_ms_per_hop']:.2f} ms a hop "
              f"(x{run['flow_hops']}), HiFT {run['hift_ms_per_hop']:.2f} ms a hop "
              f"(x{run['hift_calls']})")
        if i > 0:
            runs.append(run)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(r["tokens_decoded"] for r in runs)
    decode = {"decode_b1_step": dm.launches, "by_kernel": dict(dm.kernel_launches),
              "wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"]}
    per_token = dm.launches / n_tok
    want = sum(dm.launches_per_step(COSY_L).values())
    check(per_token == want, f"decode launches a token {per_token}, want {want}")
    check(decode["wkv7_fwd"] == COSY_L * len(runs),
          f"wkv7 prefill launches {decode['wkv7_fwd']}, want {COSY_L} an utterance")
    lm_ms = sum(r["lm_ms_per_token"] * r["tokens_decoded"] for r in runs) / n_tok
    summary = {
        "ttfa_ms": [r["ttfa_ms"] for r in runs], "rtf": [r["rtf"] for r in runs],
        "audio_s": [r["audio_s"] for r in runs], "lm_ms_per_token": lm_ms,
        "decode_kernel_share": kernel_ms / lm_ms,
        "flow_ms_per_hop": [r["flow_ms_per_hop"] for r in runs],
        "hift_ms_per_hop": [r["hift_ms_per_hop"] for r in runs],
        "decode_launches_per_token": per_token, "peak_gib": peak / 2**30, "launches": decode,
    }
    print(f"cosy main: decode {per_token:.0f} launches a token {decode['by_kernel']} over "
          f"{n_tok} tokens, wkv7_fwd {decode['wkv7_fwd']}; decode step {kernel_ms:.4f} ms = "
          f"{summary['decode_kernel_share']:.3f} of the LM's {lm_ms:.4f} ms a token; peak memory "
          f"{peak / 2**30:.2f} GiB on {card}")
    # where a hop's time goes: the last flow and HiFT hops again, profiled
    for name, tap in (("flow", flow_tap), ("hift", hift_tap)):
        summary[f"{name}_hop_busy"] = profile_call(f"cosy main: {name} hop", tap.fn, *tap.last)
    return summary


def profile_call(what: str, fn, args, kwargs) -> float:
    """One call of fn under torch.profiler: wall ms, device busy share,
    the largest kernels. Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_kernel = kernel_totals(prof)
    busy = sum(t for t, _ in by_kernel.values()) / 1e3
    n = sum(c for _, c in by_kernel.values())
    print(f"{what}: profiled: wall {wall:.2f} ms, device busy {busy:.2f} ms ({busy / wall:.3f}), "
          f"{n} device ops")
    for name, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"{what}:   {t / 1e3:8.3f} ms, {c:5d} launches  {name[:100]}")
    return busy / wall


def kernel_totals(prof) -> dict:
    """{kernel name: (device microseconds, launches)} of a torch.profiler
    run: kernels, copies and fills, not the host ops."""
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA":
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        old = by_kernel.get(ev.key, (0.0, 0))
        by_kernel[ev.key] = (old[0] + t, old[1] + ev.count)
    return by_kernel


# ---------------------------------------------------------------------------
# 14-16. Spark serving: the WKV step kernel, a small pool on card vs CPU,
# then the launcher path at full width
# ---------------------------------------------------------------------------


def step_inputs(g: torch.Generator, Bn: int, H: int, dtype):
    """One decode step's r, w_raw, k, v, z, b (Bn, H, 64) in the model's
    ranges, as wkv_inputs."""
    dev = g.device
    f = lambda: torch.randn(Bn, H, 64, generator=g, device=dev)
    r, k, v = f(), 0.3 * f(), f()
    w_raw = -0.5 - f().abs()
    kk = torch.nn.functional.normalize(f(), dim=-1)
    a = torch.sigmoid(f())
    return [x.to(dtype).contiguous() for x in (r, w_raw, k, v, -kk, kk * a)]


def phase_wkv7_step(dev) -> dict:
    from rwkvtts_torch.ops import wkv7_step_packed as sp

    g = torch.Generator(device=dev).manual_seed(5)
    err = 0.0
    # (carry, vectors, limit on y, limit on the state): y is rounded to the
    # vectors' dtype, the state to the carry's; at the Spark pool's shape,
    # the Cosy pool's (8 slots, 2048 / 64 heads) and the XY paths' (B = 8
    # and synthesize's B = 1, 1024 / 64 heads)
    cases = ((torch.float32, torch.float32, 1e-4, 1e-4),
             (torch.float32, torch.bfloat16, 2e-2, 1e-4),   # the pools' default
             (torch.bfloat16, torch.bfloat16, 2e-2, 2e-2))
    for (Bn, H), (carry, vdt, ytol, stol) in itertools.product(
            ((SERVE_SLOTS, SERVE_H), (SERVE_COSY_STREAMS, COSY_C // 64),
             (XY_B, XY_C // 64), (1, XY_C // 64)), cases):
        s_k = (0.1 * torch.randn(Bn, H, 64, 64, generator=g, device=dev)).to(carry)
        s_p = s_k.clone()
        ey = 0.0
        for _ in range(4):
            vecs = step_inputs(g, Bn, H, vdt)
            ptr = s_k.data_ptr()
            y_k, out = sp.wkv7_step_packed(s_k, *vecs, inplace=True)
            check(out.data_ptr() == ptr, "wkv7 step did not update the state in place")
            y_p, s_p = sp.wkv7_step_plain(s_p, *vecs, inplace=True)
            check(bool(torch.isfinite(y_k).all()) and y_k.dtype == vdt, "wkv7 step y")
            ey = max(ey, rel(y_k, y_p))
            if vdt == torch.float32:
                err = max(err, max_abs(y_k, y_p))
        es = rel(s_k, s_p)
        print(f"wkv7 step: carry {str(carry)[6:]}, vectors {str(vdt)[6:]}, B={Bn} H={H}, 4 "
              f"in-place steps: y rel {ey:.3e} (limit {ytol:g}), state rel {es:.3e} "
              f"(limit {stol:g})")
        check(ey <= ytol and es <= stol, "wkv7 step kernel disagrees with wkv7_step_plain")

    # time: one step a layer over 24 layers' states, as the pool steps them
    # (each layer's state is cold in L2 when its turn comes), bf16 vectors;
    # the Spark pool's shape with both carries, the Cosy pool's with f32
    L = 24
    times = {}
    for Bn, H, carry in ((SERVE_SLOTS, SERVE_H, torch.float32),
                         (SERVE_SLOTS, SERVE_H, torch.bfloat16),
                         (SERVE_COSY_STREAMS, COSY_C // 64, torch.float32)):
        vecs = step_inputs(g, Bn, H, torch.bfloat16)
        states = [torch.zeros(Bn, H, 64, 64, dtype=carry, device=dev) for _ in range(L)]

        def kernel():
            for s in states:
                sp.wkv7_step_packed(s, *vecs, inplace=True)

        def plain():
            for s in states:
                sp.wkv7_step_plain(s, *vecs, inplace=True)

        call_ms = cuda_ms(kernel, 20) / L
        ms = device_ms(kernel, "step_kernel", 5, L)
        plain_ms = cuda_ms(plain, 2) / L
        # bytes: the state read and written, the six vectors read and y written
        bms, by = bound_ms(2 * nbytes(states[0]) + 7 * nbytes(vecs[0]), 7 * Bn * H * 4096,
                           F32_FLOPS)
        times[Bn, carry] = (ms, call_ms, plain_ms, bms, by)
        print(f"wkv7 step: carry {str(carry)[6:]}, B={Bn} H={H}: kernel {ms:.4f} ms a layer "
              f"on the device ({call_ms:.4f} ms a call from the host), plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); {1e-9 * 2 * nbytes(states[0]) / (ms / 1e3):.1f} GB/s "
              f"of state")
    ms, call_ms, plain_ms, bms, by = times[SERVE_SLOTS, torch.float32]
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    return {"name": "wkv7_step", "route": "cuda", "source": STEP_SOURCE,
            "replaces": STEP_REPLACES, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "bf16_carry": dict(zip(keys, times[SERVE_SLOTS, torch.bfloat16])),
            "cosy_pool": dict(zip(keys, times[SERVE_COSY_STREAMS, torch.float32]))}


def serve_prompts(n: int, seed: int):
    """n single-request prompts: [TAG2][text][TAG0][32 global tokens][TAG1]
    with random text and voice tokens, and a cap each."""
    import numpy as np

    from rwkvtts_torch.data import spark_collator

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = spark_collator.build_prompt(rng.integers(1, 4000, rng.integers(4, 20)).tolist(),
                                        rng.integers(0, 4096, 32).tolist())
        out.append((spark_collator.pad_prompts_left([s]), int(rng.integers(8, 25))))
    return out


class _GapRecorder:
    """Wraps sampling.sample_rows (the pool's sampler) and records, for each
    row's first draw at (seed, n), two margins a rounding difference must
    cross to change that draw: the gap between its two largest
    Gumbel-perturbed logits, and the smallest gap between two neighbours
    of the sorted candidate logits up to the first one the nucleus drops
    (the noise is drawn by position in that order, so a swap of two
    neighbours swaps their noise). Restores the sampler on exit."""

    def __enter__(self):
        from rwkvtts_torch.ops import sampling

        self.gaps, self.cands, self.fn = {}, {}, sampling.sample_rows

        def wrapped(logits, *, temperature, top_k, top_p, seed, n, noise=None):
            x = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
            k = top_k if 0 < top_k < x.shape[-1] else x.shape[-1]
            vals, idx = torch.topk(x, k, dim=-1)
            # each row's leading candidates (logit, token) in sorted order
            for key, v, t in zip(zip(seed.tolist(), n.tolist()), vals[:, :6].tolist(),
                                 idx[:, :6].tolist()):
                self.cands.setdefault(key, list(zip(v, t)))
            probs = torch.softmax(vals, -1)
            keep = torch.cumsum(probs, -1) - probs < top_p.float()[:, None]
            keep[:, 0] = True
            pert = torch.where(keep, vals, -math.inf) + sampling.row_noise(seed, n, k)
            top2 = pert.topk(2, dim=-1).values
            # neighbours j, j + 1 with j < the kept count
            near = vals[:, :-1] - vals[:, 1:]
            near = torch.where(keep[:, :-1], near, math.inf).amin(-1)
            for key, gap, order in zip(zip(seed.tolist(), n.tolist()),
                                       (top2[:, 0] - top2[:, 1]).tolist(), near.tolist()):
                self.gaps.setdefault(key, (gap, order))
            return self.fn(logits, temperature=temperature, top_k=top_k, top_p=top_p,
                           seed=seed, n=n, noise=noise)

        sampling.sample_rows = wrapped
        return self

    def __exit__(self, *exc):
        from rwkvtts_torch.ops import sampling

        sampling.sample_rows = self.fn


class _PlainMegaStep:
    """Routes the B=64 pool's decode step to decode_step_plain on whatever
    device its tensors lie (a diagnostic: the card's plain version);
    restores the wrapper on exit."""

    def __enter__(self):
        from rwkvtts_torch.ops import decode_mega_b64 as dmb

        self.fn = dmb.decode_step_mega_b64
        dmb.decode_step_mega_b64 = dmb.decode_step_plain
        return self

    def __exit__(self, *exc):
        from rwkvtts_torch.ops import decode_mega_b64 as dmb

        dmb.decode_step_mega_b64 = self.fn


class _StepTap:
    """Wraps the B=64 step the pool calls (kernel or plain, whichever is
    installed) and the pool's sampler, recording in order each step's
    input, state before it and hidden after it, and each draw's rows
    (seed, n); restores both on exit."""

    def __enter__(self):
        from rwkvtts_torch.ops import decode_mega_b64 as dmb, sampling

        self.events, self.step_fn, self.sample_fn = [], dmb.decode_step_mega_b64, sampling.sample_rows

        def step(mega, cfg, x, state, **kw):
            self.mega, self.cfg = mega, cfg
            before = {k: v.clone() for k, v in state.items()}
            h, st = self.step_fn(mega, cfg, x, state, **kw)
            self.events.append(("step", x.clone(), before, h.clone()))
            return h, st

        def sample(logits, *, seed, n, **kw):
            self.events.append(("draw", list(zip(seed.tolist(), n.tolist()))))
            return self.sample_fn(logits, seed=seed, n=n, **kw)

        dmb.decode_step_mega_b64, sampling.sample_rows = step, sample
        return self

    def __exit__(self, *exc):
        from rwkvtts_torch.ops import decode_mega_b64 as dmb, sampling

        dmb.decode_step_mega_b64, sampling.sample_rows = self.step_fn, self.sample_fn

    def step_before(self, key):
        """The step whose hidden fed the draw `key` = (seed, n), and the
        draw's row."""
        last = None
        for ev in self.events:
            if ev[0] == "step":
                last = ev
            elif key in ev[1]:
                return last, ev[1].index(key)
        raise KeyError(key)


def phase_serve_small(dev) -> None:
    import contextlib

    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.serving.continuous import ContinuousBatcher

    cfg = spark.default_config(hidden_size=256, num_layers=2, dtype=torch.float32,
                               decode_wkv_packed=True)
    g = torch.Generator().manual_seed(31)
    params = spark.init_params(g, cfg)
    randomize(params, g)
    params["head"] = 10.0 * params["head"]  # greedy gaps far above rounding noise
    prompts = serve_prompts(12, 32)

    def pool(where, mega, top_k, top_p, plain_step=False, tap=None):
        p = rwkv7.tree_map(lambda t: t.to(where), params)
        if not mega:
            p = rwkv7.pack_decode_params(p, cfg.backbone)
        cb = ContinuousBatcher(p, cfg, n_slots=64 if mega else 8, chunk=4,
                               prompt_cap=32, top_k=top_k, top_p=top_p, megakernel=mega)
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(_GapRecorder()) if top_k > 1 else None
            if plain_step:
                stack.enter_context(_PlainMegaStep())
            if tap is not None:
                stack.enter_context(tap)
            rids = [cb.add_request(pb, cap, seed=7 + i) for i, (pb, cap) in enumerate(prompts)]
            got = cb.drain()
        return [got[r] for r in rids], (rec.gaps if rec else {}), (rec.cands if rec else {})

    def flips(what, t_dev, gaps_dev, t_cpu, gaps_cpu):
        """Each request whose tokens differ: the index of its first
        differing token and the top-two gap of that draw on both sides."""
        for i, (a, b) in enumerate(zip(t_dev, t_cpu)):
            if a == b:
                continue
            j = next((j for j, (u, v) in enumerate(zip(a, b)) if u != v), min(len(a), len(b)))
            (gd, od), (gc, oc) = (g.get((7 + i, j), (math.nan, math.nan))
                                  for g in (gaps_dev, gaps_cpu))
            print(f"{what}: request {i} first differs at token {j}: top-two perturbed gap "
                  f"{gd:.6f} card / {gc:.6f} CPU; nearest sorted neighbours {od:.3e} card "
                  f"/ {oc:.3e} CPU")

    def candidates(what, t_routes):
        """For each request whose tokens differ between the routes, its
        first differing draw's leading candidates on each route: sorted
        position, token and logit."""
        toks = [t for t, _ in t_routes.values()]
        for i in range(len(toks[0])):
            rows = [t[i] for t in toks]
            if all(r == rows[0] for r in rows):
                continue
            j = min(next((j for j, (u, v) in enumerate(zip(a, b)) if u != v), min(len(a), len(b)))
                    for a in rows for b in rows if a != b)
            for route, (_, cands) in t_routes.items():
                c = cands.get((7 + i, j), [])
                print(f"{what}: request {i}, draw {j}, {route}: " + ", ".join(
                    f"#{p} {tok} {logit:.6f}" for p, (logit, tok) in enumerate(c)))

    def step_origin(what, tap_k, tap_p, t_k, t_p):
        """For each request whose kernel-pool tokens differ from the
        plain-pool ones, at the first differing draw: the hidden that fed
        it, the kernel's against decode_step_plain on the card from the
        same input and state (one step's rounding), and against the plain
        pool's (all steps'); and the carried state before that step, the
        kernel pool's against the plain pool's, by leaf."""
        from rwkvtts_torch.ops import decode_mega_b64 as dmb

        for i, (a, b) in enumerate(zip(t_k, t_p)):
            if a == b:
                continue
            j = next((j for j, (u, v) in enumerate(zip(a, b)) if u != v), min(len(a), len(b)))
            (_, x, before, h_k), r = tap_k.step_before((7 + i, j))
            (_, _, before_p, h_p), rp = tap_p.step_before((7 + i, j))
            h_1, _ = dmb.decode_step_plain(tap_k.mega, tap_k.cfg, x,
                                           {k: v.clone() for k, v in before.items()})
            leaves = ", ".join(f"{k} {rel(before[k][:, r], before_p[k][:, rp]):.3e}"
                               for k in before)
            print(f"{what}: request {i}, draw {j}: hidden rel, kernel vs plain from the same "
                  f"step input and state {rel(h_k[r], h_1[r]):.3e}; kernel pool vs plain pool "
                  f"{rel(h_k[r], h_p[rp]):.3e}; carried state before the step, kernel pool vs "
                  f"plain pool: {leaves}")
            # the first step after which the row's carried state differs
            steps_k = [ev for ev in tap_k.events if ev[0] == "step"]
            steps_p = [ev for ev in tap_p.events if ev[0] == "step"]
            for n, ((_, xk, bk, hk), (_, xp, bp, hp)) in enumerate(zip(steps_k[1:], steps_p[1:])):
                diff = {k: (bk[k][:, r] != bp[k][:, rp]).sum().item() for k in bk}
                if any(diff.values()):
                    _, _, b0, _ = steps_k[n]
                    print(f"{what}: request {i}: the pools' carried state first differs after "
                          f"step {n} of {len(steps_k)} (elements by leaf {diff}; that step's "
                          f"input equal {torch.equal(steps_k[n][1][r], steps_p[n][1][rp])}, state "
                          f"before it equal {all(torch.equal(b0[k][:, r], steps_p[n][2][k][:, rp]) for k in b0)}); "
                          f"largest differences by leaf: "
                          + ", ".join(f"{k} {max_abs(bk[k][:, r], bp[k][:, rp]):.3e} of max "
                                      f"{bp[k][:, rp].abs().max().item():.3e}" for k in bk))
                    break

    for mega in (False, True):
        for top_k, top_p in ((1, 1.0), (50, 0.95)):
            t_cpu, gaps_cpu, cands_cpu = pool("cpu", mega, top_k, top_p)
            tap_k, tap_p = _StepTap(), _StepTap()
            t_gpu, gaps_gpu, cands_gpu = pool(dev, mega, top_k, top_p,
                                              tap=tap_k if mega and top_k > 1 else None)
            n = sum(len(t) for t in t_gpu)
            same = t_cpu == t_gpu
            rows = sum(a == b for a, b in zip(t_gpu, t_cpu))
            firsts = all(a[:1] == b[:1] for a, b in zip(t_gpu, t_cpu))
            what = f"serve small: {'mega (64 slots)' if mega else 'packed (8 slots)'}"
            print(f"{what}, top-k {top_k} / top-p {top_p}, 12 requests, {n} tokens: card vs "
                  f"CPU tokens identical {same} ({rows} of 12 requests, first tokens {firsts})")
            check(n > 0 and firsts, f"serve small first tokens differ: card {t_gpu} cpu {t_cpu}")
            if mega and top_k > 1:
                flips(what + " kernel", t_gpu, gaps_gpu, t_cpu, gaps_cpu)
                # the same pool with the plain step on the card: what the
                # card's own summation order does to the sampled draws
                t_pl, gaps_pl, cands_pl = pool(dev, mega, top_k, top_p, plain_step=True,
                                               tap=tap_p)
                print(f"{what} with decode_step_plain on the card: card vs CPU tokens "
                      f"identical for {sum(a == b for a, b in zip(t_pl, t_cpu))} of 12 requests")
                flips(what + " plain on the card", t_pl, gaps_pl, t_cpu, gaps_cpu)
                candidates(what, {"kernel": (t_gpu, cands_gpu),
                                  "plain on the card": (t_pl, cands_pl),
                                  "CPU": (t_cpu, cands_cpu)})
                step_origin(what, tap_k, tap_p, t_gpu, t_pl)
            # the B=64 step's bf16 rounding points agree with its plain
            # version to ~1e-3, enough to flip a near-tie of a sampled draw
            # and every later token of that request; the greedy draws and
            # the all-f32 packed pool must agree exactly
            if not (mega and top_k > 1):
                check(same, f"serve small tokens differ: card {t_gpu} cpu {t_cpu}")

    # decode_step_plain itself, card vs CPU, at this pool's widths: one
    # step from the same inputs
    bb = cfg.backbone
    gi = torch.Generator().manual_seed(33)
    mega_c = dmb.pack_mega_b64(params, bb)
    L, C, H = bb.num_layers, bb.hidden_size, bb.num_heads
    st0 = dmb.pack_state({"att_x": 0.5 * torch.randn(L, B, C, generator=gi),
                          "wkv": 0.1 * torch.randn(L, B, H, 64, 64, generator=gi),
                          "ffn_x": 0.5 * torch.randn(L, B, C, generator=gi)})
    x = torch.randn(B, C, generator=gi)
    on = lambda d: (dmb.MegaPack({k: v.to(d) for k, v in mega_c.items()}), bb, x.to(d),
                    {k: v.clone().to(d) for k, v in st0.items()})
    h_c, _ = dmb.decode_step_plain(*on("cpu"))
    h_g, _ = dmb.decode_step_plain(*on(dev))
    h_k, _ = dmb.decode_step_mega_b64(*on(dev))
    print(f"serve small: one B=64 step at 256 x 2 vs decode_step_plain on the CPU: hidden rel "
          f"{rel(h_g.cpu(), h_c):.3e} (plain on the card), {rel(h_k.cpu(), h_c):.3e} (kernel)")


def phase_serve_main(dev, card: str) -> dict:
    import random
    import threading
    import urllib.request

    import numpy as np

    from rwkvtts_torch.convert import export_hf
    from rwkvtts_torch.models import spark
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving import http_server, launch
    from rwkvtts_torch.serving import service as svc

    L = SERVE_LAYERS
    t0 = time.perf_counter()
    cfg = spark.default_config(hidden_size=SERVE_HIDDEN, num_layers=L)
    params = spark.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        export_hf.save_pretrained(params, cfg, d)
        del params
        t1 = time.perf_counter()
        pipe = launch.build_pipeline(os.path.join(d, "model.safetensors"))
        t2 = time.perf_counter()
        int4_run = spark_int4_request(os.path.join(d, "model.safetensors"), card)
        torch.cuda.empty_cache()
    t2b = time.perf_counter()
    tts = launch.build_service(pipe, n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                               max_new_tokens=SERVE_MAX_NEW, top_k=50, top_p=0.95)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"serve main: Spark {SERVE_HIDDEN} x {L} random weights (seed 0) written as "
          f"model.safetensors in {t1 - t0:.1f} s, loaded by build_pipeline in {t2 - t1:.1f} s, "
          f"service with {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}, warmed up in "
          f"{t3 - t2b:.1f} s")
    cb = tts.batcher
    check(cb.params_l is not None and not cb.megakernel
          and pipe.cfg.backbone.decode_wkv_packed and "fused_a" in pipe.params["blocks"]["att"],
          "serve main: not the launcher's default pool")

    generated = []
    finish = tts._finish
    tts._finish = lambda toks, g: (generated.append(len(toks)), finish(toks, g))[1]
    rng = random.Random(0)
    voices = [[rng.randint(0, 4000) for _ in range(32)] for _ in range(SERVE_REQUESTS + 4)]
    reqs = [svc.TTSRequest(text="benchmark sentence " * rng.randint(1, 5) + str(i),
                           global_tokens=voices[i],
                           max_new_tokens=rng.choice([64, 128, 192, 256]))
            for i in range(SERVE_REQUESTS + 4)]
    server, port = http_server.start_background(tts)
    http_status = [None] * 4

    def post(i):
        r = reqs[i]
        body = json.dumps({"text": r.text, "global_tokens": r.global_tokens,
                           "max_new_tokens": r.max_new_tokens}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/api/rwkv_tts", data=body,
                headers={"Content-Type": "application/json"}), timeout=600) as resp:
            resp.read()
            http_status[i] = (resp.status, resp.headers["Content-Type"])

    t0 = time.perf_counter()
    try:
        posts = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in posts:
            t.start()
        for t in posts:
            t.join()
        stats_http = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/stats", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
    check(all(h == (200, "audio/wav") for h in http_status),
          f"serve main: HTTP answers {http_status}")
    t_http = time.perf_counter() - t0

    # the burst is what the numbers below describe: counters from here
    results, lat = [None] * SERVE_REQUESTS, [0.0] * SERVE_REQUESTS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sp.reset_launches()
    wkv7_cuda.reset_launches()
    cb.reset_stats()

    def call(i):
        t = time.perf_counter()
        results[i] = tts.synthesize(reqs[4 + i], timeout=900)
        lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=call, args=(i,)) for i in range(SERVE_REQUESTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    st = tts.stats()
    tts.close()
    errors = [r.error for r in results if r is None or r.error]
    launches = {"wkv7_step": sp.launches, "wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"]}
    steps = st["chunks"] * SERVE_CHUNK
    n_tok = sum(generated)
    caps = sum(min(r.max_new_tokens, SERVE_MAX_NEW) for r in reqs)
    print(f"serve main: {SERVE_REQUESTS + 4} requests (4 over HTTP in {t_http:.2f} s, "
          f"HTTP /api/stats mode {stats_http['mode']} after {stats_http['chunks']} chunks), "
          f"{len(results) - len(errors)} + 4 answered, {len(errors)} errors; {n_tok} tokens "
          f"generated (caps {caps})")
    check(not errors, f"serve main: errors {errors[:3]}")
    check(len(generated) == SERVE_REQUESTS + 4 and 0 < n_tok <= caps,
          f"serve main: {len(generated)} finished rows, {n_tok} tokens")
    check(launches["wkv7_step"] == L * steps,
          f"serve main: wkv7_step launched {launches['wkv7_step']} times, want {L} x {steps}")
    check(launches["wkv7_fwd"] > 0 and launches["wkv7_fwd"] % L == 0,
          f"serve main: wkv7_fwd launched {launches['wkv7_fwd']} times")
    lat_ms = sorted(1e3 * x for x in lat)
    summary = {
        "requests": SERVE_REQUESTS + 4, "errors": len(errors), "tokens": n_tok,
        "wall_s": wall, "tok_per_s": (n_tok - sum(generated[:4])) / wall,
        "occupancy": st["occupancy"], "chunk_ms_per_step": st["chunk_ms_per_step"],
        "admit_s": st["admit_s"], "chunk_s": st["chunk_s"], "host_s": st["host_s"],
        "chunks": st["chunks"], "decode_steps": steps,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p95_ms": float(np.percentile(lat_ms, 95)),
        "peak_gib": peak / 2**30, "launches": launches, "int4_request": int4_run,
    }
    print(f"serve main: {SERVE_REQUESTS} concurrent requests: {wall:.3f} s, "
          f"{summary['tok_per_s']:.1f} tok/s sustained on {card}; occupancy "
          f"{st['occupancy']}, {st['chunk_ms_per_step']} ms a step in chunks, admit "
          f"{st['admit_s']} s, chunk {st['chunk_s']} s, host {st['host_s']} s over "
          f"{st['chunks']} chunks; latency p50 {summary['latency_p50_ms']:.1f} ms, p95 "
          f"{summary['latency_p95_ms']:.1f} ms; launches {launches} ({L} x {steps} decode "
          f"steps); peak memory {peak / 2**30:.2f} GiB")
    summary.update(profile_pool(cb, pipe, reqs))
    return summary


def profile_pool(cb, pipe, reqs) -> dict:
    """Two chunks of a full pool under torch.profiler, driven from this
    thread once the service's worker has stopped: wall, device busy share,
    the largest kernels and the WKV step kernel's share."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs[:cb.n_slots]:
        cb.add_request(pipe._prompt_batch([r.text], [r.global_tokens], [[]], [None]),
                       SERVE_MAX_NEW)
    cb.step()  # admission + one chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.step()
        cb.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_kernel = kernel_totals(prof)
    busy = sum(t for t, _ in by_kernel.values()) / 1e3
    n = sum(c for _, c in by_kernel.values())
    step_t = sum(t for k, (t, _) in by_kernel.items() if "step_kernel" in k) / 1e3
    print(f"serve main: profiled 2 chunks ({2 * cb.chunk} steps, {cb.n_slots} rows): wall "
          f"{wall:.2f} ms, device busy {busy:.2f} ms ({busy / wall:.3f}), {n} device ops; "
          f"WKV step kernel {step_t:.2f} ms ({step_t / busy:.3f} of busy)")
    for name, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"serve main:   {t / 1e3:8.3f} ms, {c:5d} launches  {name[:100]}")
    return {"profiled_wall_ms": wall, "profiled_busy_share": busy / wall,
            "step_kernel_share_of_busy": step_t / busy}


# ---------------------------------------------------------------------------
# 17-18. The Spark text->wav route: BiCodec small on card vs CPU (the golden),
# then the route at full width
# ---------------------------------------------------------------------------


def golden_bicodec_config():
    """tests/golden_configs.py's reduced BiCodec, in the port's types."""
    from rwkvtts_torch.codecs import bicodec as bc

    return bc.BiCodecConfig(
        mel=bc.MelParams(sample_rate=16000, n_fft=256, win_length=160, hop_length=80,
                         mel_fmin=10.0, mel_fmax=None, num_mels=32),
        encoder=bc.VocosStackConfig(12, 16, 32, 2, 10, sample_ratios=(2, 2)),
        quantizer_codebook_size=32, quantizer_codebook_dim=4, quantizer_input_dim=10,
        prenet=bc.VocosStackConfig(10, 16, 32, 2, 12, sample_ratios=(2, 2), condition_dim=12),
        postnet=bc.VocosStackConfig(12, 16, 32, 2, 32),
        wave=bc.WaveGeneratorConfig(input_channel=12, channels=16, rates=(4, 2),
                                    kernel_sizes=(8, 4)),
        speaker=bc.SpeakerEncoderConfig(input_dim=32, out_dim=12, latent_dim=16, token_num=4,
                                        fsq_levels=(4, 4, 4, 4, 4, 4), fsq_num_quantizers=1))


def phase_spark_wav_small(dev) -> None:
    """The golden's reduced BiCodec on the card vs the CPU: tokens equal, mel
    within 1e-5 and wav within 1e-4 relative (both f32 with TF32 off: only
    the summation order differs), and vs the reference's recorded outputs
    at the JAX package's golden gates (mel 2e-4, wav 2e-3 absolute)."""
    from rwkvtts_torch.codecs import bicodec, torch_import
    from rwkvtts_torch.utils import fixtures

    sd, io = fixtures.load_golden(GOLDEN_BICODEC)
    cfg = golden_bicodec_config()
    out = {}
    for where in ("cpu", dev):
        p = torch_import.bicodec_from_state_dict(sd, cfg, where)
        ref = torch.from_numpy(io["ref_wav"]).to(where)
        mel = bicodec.ref_mel(cfg, ref)
        sem, glob = bicodec.tokenize(p, cfg, torch.from_numpy(io["feat"]).to(where), ref)
        out[str(where)] = [t.cpu() for t in (mel, sem, glob, bicodec.detokenize(p, cfg, sem, glob))]
    (mel_c, sem_c, glob_c, wav_c), (mel_g, sem_g, glob_g, wav_g) = out["cpu"], out[str(dev)]
    mel_ref = torch.from_numpy(io["mel"]).transpose(1, 2)
    wav_ref = torch.from_numpy(io["wav"][:, 0])
    print(f"spark wav small: golden BiCodec, card vs CPU: mel {rel(mel_g, mel_c):.3e} "
          f"(limit 1e-5), wav {rel(wav_g, wav_c):.3e} (limit 1e-4), semantic "
          f"{sem_g.tolist()} / {sem_c.tolist()}, global {glob_g.flatten().tolist()} / "
          f"{glob_c.flatten().tolist()}; card vs the reference: mel {max_abs(mel_g, mel_ref):.3e} "
          f"(limit 2e-4), wav {max_abs(wav_g, wav_ref):.3e} (limit 2e-3)")
    check(torch.equal(sem_g, sem_c) and torch.equal(glob_g, glob_c),
          "spark wav small: tokens differ between the card and the CPU")
    check(rel(mel_g, mel_c) <= 1e-5 and rel(wav_g, wav_c) <= 1e-4,
          "spark wav small: the card disagrees with the CPU")
    check(sem_g.tolist() == io["semantic"].tolist()
          and glob_g.flatten().tolist() == io["global_tokens"].flatten().tolist(),
          "spark wav small: tokens differ from the reference's")
    check(max_abs(mel_g, mel_ref) <= 2e-4 and max_abs(wav_g, wav_ref) <= 2e-3,
          "spark wav small: outputs differ from the reference's")


def wav_codec_config():
    """The published Spark-TTS-0.5B BiCodec."""
    from rwkvtts_torch.codecs import bicodec

    return bicodec.BiCodecConfig()


def xlsr53_config():
    """wav2vec2-large-xlsr-53's shape (its conv stack and positional
    convolution are transformers' defaults)."""
    from transformers import Wav2Vec2Config

    return Wav2Vec2Config(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                          intermediate_size=4096, feat_extract_norm="layer",
                          do_stable_layer_norm=True, conv_bias=True)


def _wav_ok(wav, n_tokens: int, hop: int) -> bool:
    import numpy as np

    return wav.shape == (n_tokens * hop,) and bool(np.isfinite(wav).all())


def phase_spark_wav_main(dev, card: str, gen_run: dict) -> dict:
    import copy

    import numpy as np

    from rwkvtts_torch.codecs import bicodec
    from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer, Wav2Vec2Frontend
    from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving import service as svc
    from rwkvtts_torch.utils import tokenizer

    cfg = wav_codec_config()
    hop, sr = cfg.latent_hop_length, cfg.mel.sample_rate
    t0 = time.perf_counter()
    codec = SparkAudioTokenizer(cfg, bicodec.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg),
        Wav2Vec2Frontend.from_config(xlsr53_config(), seed=0, device=dev))
    torch.cuda.synchronize()
    n_codec = sum(t.numel() for t in _leaves(codec.params))
    n_w2v = sum(t.numel() for t in codec.wav2vec2.model.parameters())
    print(f"spark wav main: BiCodec {n_codec / 1e6:.1f} M and wav2vec2 {n_w2v / 1e6:.1f} M "
          f"random parameters (seed 0) on the card in {time.perf_counter() - t0:.1f} s")

    # 1. phase 6's 64 x 256 generated tokens -> wav, rows of one length in
    # batches of WAV_ROWS
    toks, lens = gen_run["toks"], gen_run["lengths"].tolist()
    voices = torch.randint(0, 4096, (len(lens), 1, 32), generator=torch.Generator().manual_seed(1))
    full = [i for i, n in enumerate(lens) if n == max(lens)][:WAV_ROWS]
    codec.detokenize_rows(voices[full], toks[full], [lens[i] for i in full], WAV_ROWS)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wavs = codec.detokenize_rows(voices, toks, lens, WAV_ROWS)
    torch.cuda.synchronize()
    detok_s = time.perf_counter() - t0
    detok_peak = torch.cuda.max_memory_allocated()
    batches = sum(-(-lens.count(n) // WAV_ROWS) for n in set(lens) if n > 0)
    audio_s = sum(lens) * hop / sr
    bad = [i for i, (w, n) in enumerate(zip(wavs, lens)) if not _wav_ok(w, n, hop)]
    print(f"spark wav main: detokenize {len(lens)} rows x <= {toks.shape[1]} tokens "
          f"({sum(lens)} tokens, {audio_s:.2f} s of audio) in {batches} batches of <= "
          f"{WAV_ROWS} rows: {1e3 * detok_s:.2f} ms, {1e3 * detok_s / batches:.2f} ms a batch, "
          f"{1e3 * detok_s / audio_s:.4f} ms per audio second on {card}; peak memory "
          f"{detok_peak / 2**30:.2f} GiB; rows not finite or not tokens x {hop}: {bad}")
    check(not bad and batches > 0, f"spark wav main: bad wavs in rows {bad}")

    # 2. one WAV_CHECK_TOKENS-token row on the card vs the CPU, full width
    row = next(i for i, n in enumerate(lens) if n >= WAV_CHECK_TOKENS)
    sem = toks[row:row + 1, :WAV_CHECK_TOKENS]
    cpu_codec = SparkAudioTokenizer(cfg, rwkv7.tree_map(lambda t: t.cpu(), codec.params))
    w_g = torch.from_numpy(codec.detokenize(voices[row:row + 1], sem))
    w_c = torch.from_numpy(cpu_codec.detokenize(voices[row:row + 1], sem.cpu()))
    print(f"spark wav main: a {WAV_CHECK_TOKENS}-token row, card vs CPU (f32, TF32 off): "
          f"max|d| {max_abs(w_g, w_c):.3e} (limit 1e-3), relative {rel(w_g, w_c):.3e}, "
          f"max|wav| {w_c.abs().max().item():.3f}")
    check(w_g.shape == (1, WAV_CHECK_TOKENS * hop) and max_abs(w_g, w_c) <= 1e-3,
          "spark wav main: the full-width row disagrees with the CPU")

    # 3. zero-shot tokenize of a WAV_PROMPT_S clip through the frontend
    n = int(WAV_PROMPT_S * sr)
    rng = np.random.default_rng(2)
    clip = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(n) / sr)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)
    codec.tokenize(clip)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    glob, sem = codec.tokenize(clip)
    tok_ms = 1e3 * (time.perf_counter() - t0)
    cpu_codec.wav2vec2 = Wav2Vec2Frontend(copy.deepcopy(codec.wav2vec2.model).cpu())
    glob_c, sem_c = cpu_codec.tokenize(clip)
    del cpu_codec
    sem_eq, glob_eq = float((sem == sem_c).mean()), float((glob == glob_c).mean())
    print(f"spark wav main: tokenize {WAV_PROMPT_S} s: {tok_ms:.2f} ms on {card}; global "
          f"{glob.shape}, semantic {sem.shape}; equal to the CPU's: semantic {sem_eq:.4f}, "
          f"global {glob_eq:.4f}")
    check(glob.shape == (1, 1, 32) and sem.shape == (1, n // hop - 1)
          and 0 <= sem.min() and sem.max() < cfg.quantizer_codebook_size
          and 0 <= glob.min() and glob.max() < 4096, "spark wav main: tokenize shapes or ids")

    # 4. SparkPipeline at WAV_HIDDEN x WAV_LAYERS, B=1
    lm_cfg = spark.default_config(hidden_size=WAV_HIDDEN, num_layers=WAV_LAYERS,
                                  decode_wkv_packed=True)
    lm = spark.init_params(torch.Generator(device=dev).manual_seed(0), lm_cfg)
    lm = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, lm)
    pipe = SparkPipeline(lm_cfg, lm, tokenizer.get_world_tokenizer(n_spct=48),
                         audio_tokenizer=codec)
    del lm
    text = "The quick brown fox jumps over the lazy dog near the river at dawn."
    voice = voices[0, 0].tolist()
    props = {"gender": "female", "age": "youth-adult", "emotion": "HAPPY"}
    pipe.synthesize(text, global_tokens=voice, max_new_tokens=8)  # warm
    L = lm_cfg.backbone.num_layers
    runs = {}
    for name, kw in (("global_tokens", {"global_tokens": voice}),
                     ("properties", {"properties": props}),
                     ("prompt_wav", {"prompt_wav": clip, "prompt_text": "A prompt spoken."})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wkv7_cuda.reset_launches()
        sp.reset_launches()
        t0 = time.perf_counter()
        res = pipe.synthesize(text, max_new_tokens=WAV_NEW, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = len(res.semantic_tokens)
        launches = {"wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"], "wkv7_step": sp.launches}
        runs[name] = {"wall_s": wall, "tokens": n_tok, "generate_s": res.prefill_s,
                      "tok_per_s": res.tokens_per_s, "detokenize_ms": 1e3 * res.decode_s,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": launches}
        prefills = 2 if name == "properties" else 1  # the design's prefill and the text's
        print(f"spark wav main: synthesize ({name}): {wall:.3f} s wall, {n_tok} tokens, "
              f"generate {res.prefill_s:.3f} s ({res.tokens_per_s:.1f} tok/s), detokenize "
              f"{1e3 * res.decode_s:.2f} ms, launches {launches}, peak memory "
              f"{runs[name]['peak_gib']:.2f} GiB on {card}")
        check(n_tok > 0 and _wav_ok(res.wav, n_tok, hop),
              f"spark wav main: synthesize ({name}) wav {res.wav.shape} for {n_tok} tokens")
        check(launches["wkv7_fwd"] == prefills * L,
              f"spark wav main: wkv7_fwd launched {launches['wkv7_fwd']} times, want "
              f"{prefills} x {L}")
        check(launches["wkv7_step"] >= L * n_tok and launches["wkv7_step"] % L == 0,
              f"spark wav main: wkv7_step launched {launches['wkv7_step']} times for {n_tok} tokens")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    designed = pipe.design_voice(props)
    torch.cuda.synchronize()
    design_ms = 1e3 * (time.perf_counter() - t0)
    print(f"spark wav main: design_voice {design_ms:.2f} ms on {card}: {designed[:8]}...")
    check(len(designed) == 32 and all(0 <= t < 4096 for t in designed),
          "spark wav main: designed voice out of range")

    # 5. requests through the slot pool with the codec attached
    tts = svc.ContinuousTTSService(pipe, n_slots=8, chunk=32, max_new_tokens=128, top_k=50)
    got = []
    finish = tts._finish
    tts._finish = lambda t, g: (got.append(len(t)), finish(t, g))[1]
    wkv7_cuda.reset_launches()
    sp.reset_launches()
    try:
        t0 = time.perf_counter()
        answers = [tts.synthesize(svc.TTSRequest(text=f"{text} {i}",
                                                 global_tokens=voices[i + 1, 0].tolist(),
                                                 max_new_tokens=32 * (i + 1)), timeout=600)
                   for i in range(WAV_REQUESTS)]
        served_s = time.perf_counter() - t0
    finally:
        tts.close()
    served = {"wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"], "wkv7_step": sp.launches}
    print(f"spark wav main: {WAV_REQUESTS} requests through ContinuousTTSService with the "
          f"codec: {served_s:.3f} s, tokens {got}, wav samples {[a.wav.size for a in answers]}, "
          f"errors {[a.error for a in answers if a.error]}, launches {served}")
    check(len(got) == WAV_REQUESTS and all(
        a.error is None and _wav_ok(a.wav, n, hop) for a, n in zip(answers, got)),
          "spark wav main: served answers without tokens x 320 finite samples")
    check(served["wkv7_fwd"] > 0 and served["wkv7_step"] > 0,
          f"spark wav main: the served route launched {served}")
    console = interactive_session(pipe, card)
    return {"interactive_cli": console, "detokenize_ms": 1e3 * detok_s, "detokenize_batches": batches,
            "detokenize_ms_per_batch": 1e3 * detok_s / batches,
            "detokenize_ms_per_audio_s": 1e3 * detok_s / audio_s, "audio_s": audio_s,
            "detokenize_peak_gib": detok_peak / 2**30, "row_max_abs": max_abs(w_g, w_c),
            "tokenize_ms": tok_ms, "tokenize_equal": {"semantic": sem_eq, "global": glob_eq},
            "synthesize": runs, "design_ms": design_ms, "served_s": served_s,
            "served_launches": served,
            "launches_b64_run": {k: gen_run["launches"][k] for k in ("wkv7_fwd",
                                                                     "decode_b64_step")}}


# ---------------------------------------------------------------------------
# 19-21. Cosy zero-shot from a prompt wav, then Cosy B=64 offline generation
# ---------------------------------------------------------------------------


def golden_cosy_configs():
    """tests/golden_configs.py's reduced flow and HiFT and the reduced S3 /
    CAM++ of tests/test_goldens.py's ONNX goldens, in the port's types."""
    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import conformer, flow, hift
    from rwkvtts_torch.codecs import s3_tokenizer as s3

    fcfg = flow.FlowConfig(
        input_size=512, output_size=80, spk_embed_dim=24, vocab_size=50, token_mel_ratio=2,
        pre_lookahead_len=3,
        encoder=conformer.UpsampleConformerConfig(input_size=512, output_size=512,
                                                  attention_heads=8, linear_units=64,
                                                  num_blocks=1, num_up_blocks=4),
        estimator=flow.EstimatorConfig(in_channels=320, out_channels=80, channels=(16,),
                                       n_blocks=1, num_mid_blocks=1, num_heads=2,
                                       attention_head_dim=4, static_chunk_size=0),
        cfm=flow.CFMConfig(inference_cfg_rate=0.7))
    hcfg = hift.HiFTConfig(in_channels=16, base_channels=32, sampling_rate=24000,
                           upsample_rates=(8, 5, 3), upsample_kernel_sizes=(16, 11, 7),
                           source_resblock_kernel_sizes=(7, 7, 11),
                           source_resblock_dilation_sizes=((1, 3, 5),) * 3, f0_cond_channels=24)
    s3cfg = s3.S3TokenizerConfig(n_mels=16, d_model=32, layers=2, heads=2, ffn_dim=64, fsq_dim=8)
    ccfg = cp.CampplusConfig(feat_dim=16, embedding_size=24, m_channels=4, init_channels=16,
                             growth_rate=4, bn_size=2, block_layers=(2, 2),
                             block_dilations=(1, 2), seg_len=8)
    return fcfg, hcfg, s3cfg, ccfg


def prompt_clip(seconds: float, sr: int = 16000, seed: int = 0):
    """A voiced-looking synthetic clip: a 180 Hz tone with a slow vibrato
    and its second harmonic, plus noise."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    ph = 2 * np.pi * (180.0 * t + 3.0 * np.sin(2 * np.pi * 0.7 * t))
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph)
            + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def phase_cosy_zs_small(dev) -> None:
    """The four Cosy goldens through the port's importers on the card, at the
    JAX golden tests' gates; a zero-shot synthesize at LM 256 x 2 (bf16,
    head x 10) with tiny flow / HiFT / S3 / CAM++ on both decode routes,
    card vs CPU; cosy_generate_mega_b64 at 256 x 2 (f32), B = 64, 4 steps,
    card vs CPU on the same noise."""
    import numpy as np

    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import cosy_import, flow, hift
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.infer import generate as gen
    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import sampling
    from rwkvtts_torch.utils import fixtures

    # 1. the goldens
    fcfg, hcfg, s3cfg, ccfg = golden_cosy_configs()
    with tempfile.TemporaryDirectory() as tmp:
        onnx = {}
        for name in ("s3_onnx", "campplus_onnx"):
            g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
            onnx[name] = (os.path.join(tmp, f"{name}.onnx"), g)
            with open(onnx[name][0], "wb") as f:
                f.write(g["onnx"].tobytes())
        path, g = onnx["s3_onnx"]
        tokens, _ = s3.encode_mel(s3.s3_from_onnx(path, s3cfg, dev), s3cfg,
                                  torch.from_numpy(g["mel"]).to(dev))
        s3_same = tokens.cpu().numpy().tolist() == g["tokens"].tolist()
        path, g = onnx["campplus_onnx"]
        emb = cp.apply(cp.load_campplus_onnx(path, ccfg, dev), ccfg,
                       torch.from_numpy(g["feat"]).to(dev))
        emb_err = max_abs(emb.cpu(), torch.from_numpy(g["emb"]))
    sd, io = fixtures.load_golden(os.path.join(GOLDEN_DIR, "flow.npz"))
    tok = torch.from_numpy(np.concatenate([io["prompt_token"], io["token"]], 1)).to(dev)
    mel = flow.inference(cosy_import.flow_from_state_dict(sd, fcfg, dev), fcfg, tok,
                         torch.ones(tok.shape, device=dev),
                         torch.from_numpy(io["prompt_feat"]).to(dev), io["prompt_feat"].shape[1],
                         torch.from_numpy(io["embedding"]).to(dev),
                         torch.from_numpy(io["noise"]).transpose(1, 2).to(dev))
    mel_err = max_abs(mel.cpu(), torch.from_numpy(io["mel"]).transpose(1, 2))
    sd, io = fixtures.load_golden(os.path.join(GOLDEN_DIR, "hift.npz"))
    hp = cosy_import.hift_from_state_dict(sd, hcfg, dev)
    hmel = torch.from_numpy(io["mel"]).transpose(1, 2).to(dev)
    f0_err = max_abs(hift.f0_predict(hp["f0_predictor"], hmel).cpu(), torch.from_numpy(io["f0"]))
    wav_err = max_abs(hift.decode(hp, hcfg, hmel, torch.from_numpy(io["source"]).to(dev)).cpu(),
                      torch.from_numpy(io["wav"]))
    print(f"cosy zs small: goldens on the card vs the reference's outputs: S3 tokens equal "
          f"{s3_same}; CAM++ embedding max|d| {emb_err:.3e} (limit 1e-4); flow mel {mel_err:.3e} "
          f"(limit 5e-3); HiFT f0 {f0_err:.3e} (limit 1e-4), wav {wav_err:.3e} (limit 2e-3)")
    check(s3_same and emb_err <= 1e-4 and mel_err <= 5e-3 and f0_err <= 1e-4
          and wav_err <= 2e-3, "cosy zs small: a golden disagrees with the reference's outputs")

    # 2. zero-shot synthesize on both decode routes, card vs CPU (bf16, the
    # B=1 kernel's dtype; top-k 1 as phase 12, the RAS fallback on its noise)
    cfg = cosy.default_config(hidden_size=256, num_layers=2)
    g = torch.Generator().manual_seed(31)
    params = cosy.init_params(g, cfg)
    randomize(params, g)
    params["head"] = 10.0 * params["head"]  # draws far from a near-tie
    fcfg, fparams, hcfg, hparams = tiny_codecs()
    s3cfg = s3.S3TokenizerConfig(d_model=64, layers=2, heads=2, ffn_dim=128)
    ccfg = cp.CampplusConfig(embedding_size=fcfg.spk_embed_dim, m_channels=8, init_channels=32,
                             growth_rate=8, block_layers=(2, 2, 2))
    s3p = s3.init_params(torch.Generator().manual_seed(32), s3cfg)
    cpp = cp.init_params(torch.Generator().manual_seed(33), ccfg)
    clip = prompt_clip(2.0, seed=1)
    out = {}
    for where in ("cpu", dev):
        for route in ("decode_step", "b1_kernel"):
            pipe = CosyPipeline(cfg, params, CharTok(), fcfg, fparams, hcfg, hparams,
                                s3_cfg=s3cfg, s3_params=s3p, campplus_cfg=ccfg,
                                campplus_params=cpp, decode_megakernel=route == "b1_kernel",
                                device=where)
            front = pipe.frontend_zero_shot(clip)
            res = pipe.synthesize("hello zero shot", prompt_wav=clip, prompt_text="a prompt",
                                  max_new_tokens=24, seed=3, top_k=1)
            out[(str(where), route)] = (front, res)
    up = hcfg.total_upsample * fcfg.token_mel_ratio
    for route in ("decode_step", "b1_kernel"):
        (ft_c, fm_c, fe_c), r_c = out[("cpu", route)]
        (ft_g, fm_g, fe_g), r_g = out[(str(dev), route)]
        e_emb = float(np.abs(fe_g - fe_c).max() / np.abs(fe_c).max())
        same_prompt = ft_g.tolist() == ft_c.tolist()
        same = r_g.speech_tokens.tolist() == r_c.speech_tokens.tolist()
        finite = bool(np.isfinite(r_g.wav).all() and np.isfinite(r_c.wav).all())
        print(f"cosy zs small: LM 256 x 2 bf16, {route} route, card vs CPU: prompt tokens "
              f"({len(ft_g)}) equal {same_prompt}, embedding rel {e_emb:.3e} (limit 1e-4), "
              f"prompt mel max|d| {float(np.abs(fm_g - fm_c).max()):.3e}; generated tokens "
              f"({len(r_g.speech_tokens)}) equal {same}; wav {r_g.wav.shape} finite {finite}")
        if not same:
            d = next(i for i, (a, b) in enumerate(zip(r_g.speech_tokens, r_c.speech_tokens))
                     if a != b)
            print(f"cosy zs small: {route}: first differing token at {d}: card "
                  f"{r_g.speech_tokens[d:d + 4].tolist()} cpu {r_c.speech_tokens[d:d + 4].tolist()}")
        check(same_prompt and e_emb <= 1e-4 and same and finite
              and r_g.wav.shape == (len(r_g.speech_tokens) * up,),
              f"cosy zs small: the {route} route on the card disagrees with the CPU")

    # 3. Cosy B=64 generation through kernel 1, card vs CPU, one set of noise,
    # f32 as phase 5
    cfg = cosy.default_config(hidden_size=256, num_layers=2, dtype=torch.float32)
    n_new, V = 4, cfg.speech_head_size
    noise = sampling.ras_noise(torch.Generator().manual_seed(34), n_new, B, 25, V)
    gp = torch.Generator().manual_seed(35)
    tokens = torch.randint(0, 4000, (B, 16), generator=gp)
    modality = torch.full((B, 16), cosy.MOD_TEXT)
    mask = torch.ones(B, 16, dtype=torch.int32)
    toks = {}
    for where in ("cpu", dev):
        p = rwkv7.tree_map(lambda t: t.to(where), params)
        toks[str(where)], _ = gen.cosy_generate_mega_b64(
            p, dmb.pack_mega_b64(p, cfg.backbone), cfg,
            *(t.to(where) for t in (tokens, modality, mask)), max_new_tokens=n_new,
            noise=tuple(t.to(where) for t in noise))
    diff = (toks[str(dev)].cpu() != toks["cpu"]).nonzero().tolist()
    print(f"cosy zs small: cosy_generate_mega_b64 at 256 x 2, B={B}, {n_new} steps, top-k 25 / "
          f"top-p 0.8 on one set of noise: card vs CPU tokens differ at {diff}")
    check(not diff, "cosy zs small: the B=64 Cosy generation disagrees with the CPU")


def phase_cosy_zs_main(dev, card: str) -> dict:
    """The zero-shot route at the 1.5B pairing: frontend_zero_shot of a 6 s
    prompt (S3 and CAM++ ms, tokens, mel frames, the S3 tokens' share equal
    to the CPU's), then synthesize on both decode routes, cross-lingual,
    instruct and voice conversion, each once warm and once timed."""
    import numpy as np

    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import flow, hift
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import decode_mega as dm
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp

    t0 = time.perf_counter()
    cfg = cosy.default_config(hidden_size=COSY_C, num_layers=COSY_L)
    params = cosy.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)
    fcfg, hcfg = flow.FlowConfig(), hift.HiFTConfig()
    s3cfg, ccfg = s3.S3TokenizerConfig(), cp.CampplusConfig()
    gen_dev = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    common = (cfg, params, CharTok(), fcfg, flow.init_params(gen_dev(1), fcfg), hcfg,
              hift.init_params(gen_dev(2), hcfg))
    kw = dict(s3_cfg=s3cfg, s3_params=s3.init_params(gen_dev(3), s3cfg), campplus_cfg=ccfg,
              campplus_params=cp.init_params(gen_dev(4), ccfg), device=dev)
    # the default route of a bf16 LM on the card is the B=1 kernel's
    pipes = {"b1_kernel": CosyPipeline(*common, **kw),
             "decode_step": CosyPipeline(*common, decode_megakernel=False, **kw)}
    del params, common
    torch.cuda.synchronize()
    n_s3 = sum(t.numel() for t in _leaves(kw["s3_params"]))
    n_cp = sum(t.numel() for t in _leaves(kw["campplus_params"]))
    print(f"cosy zs main: LM {COSY_C} x {COSY_L} bf16 + flow + HiFT (defaults) + S3 "
          f"{n_s3 / 1e6:.1f} M + CAM++ {n_cp / 1e6:.2f} M random parameters, both decode routes "
          f"packed, in {time.perf_counter() - t0:.1f} s")

    # 1. the frontend of a 6 s prompt
    pipe = pipes["b1_kernel"]
    clip = prompt_clip(ZS_PROMPT_S, seed=2)

    def timed(fn, *a):
        fn(*a)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a)
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t)

    s3_tok, s3_ms = timed(pipe.speech_tokenizer_fn, clip)
    spk, cp_ms = timed(pipe.spk_embed_fn, clip)
    (ptoks, pmel, pemb), front_ms = timed(pipe.frontend_zero_shot, clip)
    cpu_s3 = rwkv7.tree_map(lambda t: t.cpu(), kw["s3_params"])
    cpu_tok = s3.tokenize(cpu_s3, s3cfg, torch.from_numpy(clip)[None])[0].numpy()
    cpu_emb = cp.embed_wav(rwkv7.tree_map(lambda t: t.cpu(), kw["campplus_params"]), ccfg,
                           torch.from_numpy(clip)[None])[0].numpy()
    del cpu_s3
    s3_eq = float((s3_tok == cpu_tok).mean()) if s3_tok.shape == cpu_tok.shape else 0.0
    emb_rel = float(np.abs(spk - cpu_emb).max() / np.abs(cpu_emb).max())
    print(f"cosy zs main: frontend of a {ZS_PROMPT_S} s 16 kHz prompt on {card}: S3 {s3_ms:.2f} ms "
          f"({len(s3_tok)} tokens, share equal to the CPU's {s3_eq:.4f}), CAM++ {cp_ms:.2f} ms "
          f"(card vs CPU rel {emb_rel:.3e}), frontend_zero_shot {front_ms:.2f} ms: "
          f"{len(ptoks)} tokens, mel {pmel.shape}, embedding {pemb.shape}")
    n_prompt = int(ZS_PROMPT_S * 25)
    check(len(ptoks) == n_prompt and pmel.shape == (2 * n_prompt, fcfg.output_size)
          and pemb.shape == (ccfg.embedding_size,) and np.isfinite(pmel).all()
          and np.isfinite(pemb).all() and 0 <= ptoks.min() and ptoks.max() < s3cfg.vocab_size,
          "cosy zs main: frontend shapes or values")
    check(emb_rel <= 1e-3, f"cosy zs main: CAM++ card vs CPU rel {emb_rel:.3e} (limit 1e-3)")

    # 2. the modes, each once warm and once timed
    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = "".join(rng.choice(letters, COSY_TEXT))
    source = prompt_clip(ZS_PROMPT_S, seed=4)
    L = COSY_L
    jobs = {
        "synthesize_b1_kernel": (pipes["b1_kernel"].synthesize, (text,),
                                 dict(prompt_wav=clip, prompt_text="A prompt spoken.")),
        "synthesize_decode_step": (pipes["decode_step"].synthesize, (text,),
                                   dict(prompt_wav=clip, prompt_text="A prompt spoken.")),
        "cross_lingual": (pipe.synthesize_cross_lingual, (text,), dict(prompt_wav=clip)),
        "instruct": (pipe.synthesize_instruct, (text, "Speak slowly and warmly."),
                     dict(prompt_wav=clip)),
        "voice_convert": (pipe.voice_convert, (source,), dict(prompt_wav=clip)),
    }
    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, (fn, args, kwargs) in jobs.items():
        lm = name != "voice_convert"
        fn(*args, **kwargs, **({"max_new_tokens": ZS_WARM_NEW} if lm else {}))  # warm
        torch.cuda.synchronize()
        dm.reset_launches()
        sp.reset_launches()
        wkv7_cuda.reset_launches()
        t = time.perf_counter()
        res = fn(*args, **kwargs, **({"max_new_tokens": ZS_NEW} if lm else {}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_tok = len(res.speech_tokens)
        launches = {"wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"], "decode_b1_step": dm.launches,
                    "wkv7_step": sp.launches}
        audio_s = len(res.wav) / res.sample_rate
        runs[name] = {"wall_s": wall, "rtf_wall": wall / audio_s, "rtf": res.rtf,
                      "llm_s": res.llm_s, "flow_s": res.flow_s, "tokens": n_tok,
                      "audio_s": audio_s, "launches": launches,
                      "lm_ms_per_token": 1e3 * res.llm_s / n_tok if lm else None}
        print(f"cosy zs main: {name}: {wall:.3f} s wall for {audio_s:.3f} s of audio (RTF "
              f"{wall / audio_s:.4f} with the frontend, {res.rtf:.4f} without), LM "
              f"{res.llm_s:.3f} s" + (f" ({1e3 * res.llm_s / n_tok:.3f} ms a token)" if lm else "")
              + f", flow + HiFT {res.flow_s:.3f} s, {n_tok} tokens, {len(res.wav)} samples, "
              f"launches {launches} on {card}")
        up = hcfg.total_upsample * fcfg.token_mel_ratio
        check(bool(np.isfinite(res.wav).all()) and res.wav.shape == (n_tok * up,),
              f"cosy zs main: {name}: wav {res.wav.shape} for {n_tok} tokens")
        want_tok = ZS_NEW if lm else n_prompt
        check(n_tok == want_tok, f"cosy zs main: {name}: {n_tok} tokens, want {want_tok}")
        want = {"wkv7_fwd": L if lm else 0,
                "decode_b1_step": sum(dm.launches_per_step(L).values()) * ZS_NEW
                if name in ("synthesize_b1_kernel", "cross_lingual", "instruct") else 0,
                "wkv7_step": L * ZS_NEW if name == "synthesize_decode_step" else 0}
        check(launches == want, f"cosy zs main: {name}: launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    print(f"cosy zs main: peak memory {peak / 2**30:.2f} GiB on {card}")
    return {"s3_ms": s3_ms, "campplus_ms": cp_ms, "frontend_ms": front_ms,
            "prompt_tokens": len(ptoks), "prompt_mel_frames": int(pmel.shape[0]),
            "s3_equal_cpu": s3_eq, "campplus_rel_cpu": emb_rel, "runs": runs,
            "peak_gib": peak / 2**30}


def phase_cosy_b64(dev, card: str) -> dict:
    """Kernel 1 at 2048 x 24 (2 chained steps vs decode_step_plain, ms a
    step, its bound), then Cosy B=64 offline generation through it: 128 +
    256 tokens, top-k 25 / top-p 0.8, audio tok/s with the prefill,
    launches, peak memory."""
    from rwkvtts_torch.infer.generate import cosy_generate_mega_b64
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import wkv7_cuda

    mega, st_k, x, err, bcfg = decode_vs_plain(dev, COSY_C, COSY_L, 41, 2)
    L = COSY_L
    ms = cuda_ms(lambda: dmb.decode_step_mega_b64(mega, bcfg, x, st_k), 20)
    st_p = {k: v.clone() for k, v in st_k.items()}
    plain_ms = cuda_ms(lambda: dmb.decode_step_plain(mega, bcfg, x, st_p), 2)
    leaves = [t for t in _leaves(mega) if torch.is_tensor(t)]
    q8 = sum(t.numel() for t in leaves if t.dtype == torch.int8)
    bms, by = bound_ms(nbytes(*leaves) + 2 * nbytes(*st_k.values()) + 2 * nbytes(x),
                       2 * B * q8, BF16_TC_FLOPS)
    print(f"cosy b64: kernel 1 at {COSY_C} x {L}, B={B}: {ms:.4f} ms a step host-timed, plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), {nbytes(*leaves) / 1e9:.4f} GB packed "
          f"on {card}")
    del mega, st_k, st_p, leaves
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = cosy.default_config(hidden_size=COSY_C, num_layers=COSY_L, decode_state_bf16=True)
    params = cosy.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)
    mega = dmb.pack_mega_b64(params, cfg.backbone)
    torch.cuda.synchronize()
    print(f"cosy b64: Cosy {COSY_C} x {L} bf16 and its int8 pack built in "
          f"{time.perf_counter() - t0:.1f} s")

    def run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        tokens = torch.randint(0, 4000, (B, PROMPT), generator=g, device=dev)
        modality = torch.full((B, PROMPT), cosy.MOD_TEXT, device=dev)
        mask = torch.ones(B, PROMPT, dtype=torch.int32, device=dev)
        return cosy_generate_mega_b64(params, mega, cfg, tokens, modality, mask,
                                      max_new_tokens=COSY_B64_NEW, top_k=25, top_p=0.8,
                                      generator=g)

    run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wkv7_cuda.reset_launches()
    dmb.reset_launches()
    t0 = time.perf_counter()
    toks, lengths = run(2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"], "decode_b64_step": dmb.launches}
    by_kernel = dict(dmb.kernel_launches)
    tps = B * COSY_B64_NEW / seconds
    print(f"cosy b64: B={B}, {PROMPT} + {COSY_B64_NEW} tokens: {seconds:.4f} s, {tps:.1f} audio "
          f"tok/s on {card} ({1e3 * seconds / COSY_B64_NEW:.4f} ms a step with sampling and the "
          f"prefill); launches {launches}, by kernel {by_kernel}; mean length "
          f"{lengths.float().mean().item():.1f}; peak memory {peak / 2**30:.2f} GiB")
    check(toks.shape == (B, COSY_B64_NEW) and lengths.shape == (B,), "cosy b64 output shapes")
    check(bool(((toks >= 0) & (toks <= cfg.eos_token_id)).all()), "cosy b64 token out of range")
    check(launches == {"wkv7_fwd": L, "decode_b64_step": (8 * L + 2) * COSY_B64_NEW},
          f"cosy b64 launches {launches}, want {L} and {8 * L + 2} a token")
    return {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": err, "seconds": seconds, "tok_per_s": tps, "launches": launches,
            "by_kernel": by_kernel, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# 22-23. The Cosy server: the slot pool and stream hub, card vs CPU, then
# the launcher's pipeline behind HTTP at the 1.5B pairing
# ---------------------------------------------------------------------------


def sfm_codecs():
    """tiny_codecs' flow as an SFM flow: a random SFM head whose t and
    log-sigma outputs are biased low, so the SFM start's noise scale
    sqrt((1 - t)^2 - sigma^2) is well away from 0 (above the clamp it is 0
    up to rounding, and its sqrt turns f32 rounding into ~1e-4 of the
    noise; tests/test_torch_cosy_sfm.py)."""
    import dataclasses

    from rwkvtts_torch.codecs import flow

    fcfg, fparams, hcfg, hparams = tiny_codecs()
    fcfg = dataclasses.replace(fcfg, sfm=True)
    head = flow.sfm_head_init(torch.Generator().manual_seed(24), fcfg.encoder.output_size,
                              fcfg.output_size)
    head["proj"]["b"][fcfg.output_size:] = torch.tensor([-3.0, -4.0])
    return fcfg, {**fparams, "sfm_head": head}, hcfg, hparams


def phase_cosy_serve_small(dev) -> None:
    """The Cosy slot pool at LM 256 x 2 (f32) on the card vs the CPU: 3
    requests, 2 slots, 4-step chunks, greedy (also against each request's
    solo cosy_generate on the card, fed the pool's draws) and sampled
    (top-k 25 / top-p 0.8 on the pool's hashed draws), overlap; kernel 7 a
    layer a pool step and kernel 2 a layer an admission; the SFM window hop
    of a tiny SFM flow, card vs CPU; the LM through the launcher's
    checkpoint loader, card vs CPU."""
    import numpy as np

    from rwkvtts_torch.data import cosy_collator
    from rwkvtts_torch.data.spark_collator import pad_prompts_left
    from rwkvtts_torch.infer import generate as gen
    from rwkvtts_torch.infer import streaming
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import sampling, wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving.cosy_pool import CosyPoolBatcher

    t_phase = time.perf_counter()
    cfg = cosy.default_config(hidden_size=256, num_layers=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(41)
    params = cosy.init_params(g, cfg)
    randomize(params, g)
    params["head"] = 10.0 * params["head"]  # greedy gaps far above rounding noise
    packed = rwkv7.pack_decode_params(params, cfg.backbone)
    rng = np.random.default_rng(42)
    reqs = [(pad_prompts_left([cosy_collator.build_prompt(
                rng.integers(10, 6000, n_text).tolist(), rng.integers(0, 6561, n_sp).tolist())]),
             cap, mn, seed)
            for n_text, n_sp, cap, mn, seed in ((6, 4, 12, 4, 5), (9, 0, 20, 6, 6),
                                                (4, 8, 16, 2, 7))]
    L, V = cfg.backbone.num_layers, cfg.speech_head_size

    def pool(where, top_k, top_p, overlap=False):
        p = rwkv7.tree_map(lambda t: t.to(where), packed)
        cb = CosyPoolBatcher(p, cfg, n_slots=2, chunk=4, prompt_cap=32, top_k=top_k,
                             top_p=top_p, overlap=overlap)
        counts = {"chunks": 0, "admissions": 0}
        chunk, prefill = cb._chunk, cb._prefill

        def counted(name, fn):
            def wrapped(*a, **kw):
                counts[name] += 1
                return fn(*a, **kw)
            return wrapped

        cb._chunk, cb._prefill = counted("chunks", chunk), counted("admissions", prefill)
        sp.reset_launches()
        wkv7_cuda.reset_launches()
        rids = [cb.add_request(pb, cap, min_new_tokens=mn, seed=s) for pb, cap, mn, s in reqs]
        out = cb.drain()
        counts.update(wkv7_step=sp.launches, wkv7_fwd=wkv7_cuda.launches["wkv7_fwd"])
        return [out[r] for r in rids], counts, p

    for top_k, top_p in ((1, 1.0), (25, 0.8)):
        t_cpu, _, _ = pool("cpu", top_k, top_p)
        t_gpu, counts, p_dev = pool(dev, top_k, top_p)
        t_ovl, _, _ = pool(dev, top_k, top_p, overlap=True)
        n = sum(len(t) for t in t_gpu)
        print(f"cosy serve small: pool LM 256 x 2 f32, 3 requests, 2 slots, chunk 4, top-k "
              f"{top_k} / top-p {top_p}: {n} tokens, card vs CPU identical {t_gpu == t_cpu}, "
              f"overlap identical {t_ovl == t_gpu}; {counts['chunks']} chunks, "
              f"{counts['admissions']} admissions, launches wkv7_step {counts['wkv7_step']}, "
              f"wkv7_fwd {counts['wkv7_fwd']}")
        check(n > 0 and t_gpu == t_cpu, f"cosy serve small tokens differ: card {t_gpu} cpu {t_cpu}")
        check(t_ovl == t_gpu, f"cosy serve small: overlap tokens {t_ovl}, want {t_gpu}")
        check(counts["wkv7_step"] == L * 4 * counts["chunks"],
              f"cosy serve small: wkv7_step {counts['wkv7_step']}, want {L} a step")
        check(counts["wkv7_fwd"] == L * counts["admissions"],
              f"cosy serve small: wkv7_fwd {counts['wkv7_fwd']}, want {L} an admission")
        if top_k == 1:  # each request alone through cosy_generate, fed the pool's draws
            solo = []
            for pb, cap, mn, s in reqs:
                k = min(top_k, V)
                nuc, fb = sampling.ras_row_noise(torch.full((cap,), s, device=dev),
                                                 torch.arange(cap, device=dev), k, V)
                t = {key: torch.from_numpy(np.asarray(v, np.int64)).to(dev)
                     for key, v in pb.items()}
                toks, length = gen.cosy_generate(
                    p_dev, cfg, t["tokens"], t["modality"], t["attention_mask"],
                    max_new_tokens=cap, min_new_tokens=mn, top_k=1,
                    noise=(nuc[:, None], fb[:, None]))
                solo.append(toks[0, :int(length[0])].tolist())
            print(f"cosy serve small: each request alone through cosy_generate on the card: "
                  f"the pool's tokens {solo == t_gpu}")
            check(solo == t_gpu, f"cosy serve small: solo {solo}, pool {t_gpu}")

    # the SFM window hop of a tiny SFM flow, card vs CPU (TF32 off)
    from rwkvtts_torch.codecs import flow

    fcfg, fparams, _, _ = sfm_codecs()
    P, ctx, hop, la = 4, 8, 6, fcfg.pre_lookahead_len
    cap = P + ctx + hop + la
    gi = torch.Generator().manual_seed(44)
    buf = torch.randint(0, 6561, (1, cap), generator=gi)
    spk = torch.randn(1, fcfg.spk_embed_dim, generator=gi)
    table = flow.NoiseTable(9, fcfg.output_size)(2 * (cap + 5))
    mels = {}
    for where in ("cpu", dev):
        to = lambda t: t.to(where)
        mels[str(where)] = streaming._flow_hop(
            rwkv7.tree_map(to, fparams), fcfg, to(table), to(buf), cap - 2, None, P, 5, ctx,
            hop + la, to(spk), 5, sfm=True).cpu()
    err = rel(mels[str(dev)], mels["cpu"])
    print(f"cosy serve small: SFM window hop (tiny SFM flow, 5 steps, window {cap} tokens): "
          f"card vs CPU rel {err:.3e}, finite {bool(torch.isfinite(mels[str(dev)]).all())}")
    check(err <= 1e-4 and bool(torch.isfinite(mels[str(dev)]).all()),
          f"cosy serve small: SFM hop card vs CPU rel {err:.3e} (limit 1e-4)")

    # the launcher's loader: the LM as a checkpoint written by the port's
    # exporter, loaded by launch.build_cosy_pipeline (bf16 matrices) on the
    # card and on the CPU; the two pools' greedy tokens
    from rwkvtts_torch.convert import export_hf
    from rwkvtts_torch.serving import launch

    with tempfile.TemporaryDirectory() as d:
        export_hf.save_pretrained(params, cfg, d, kind="cosy")
        toks = {}
        for where in ("cpu", dev):
            pipe = launch.build_cosy_pipeline(os.path.join(d, "model.safetensors"), device=where)
            cb = CosyPoolBatcher(pipe.lm_params, pipe.lm_cfg, n_slots=2, chunk=4, prompt_cap=32,
                                 top_k=1)
            rids = [cb.add_request(pb, cap, min_new_tokens=mn, seed=s) for pb, cap, mn, s in reqs]
            out = cb.drain()
            toks[str(where)] = [out[r] for r in rids]
    same = toks[str(dev)] == toks["cpu"]
    print(f"cosy serve small: launch.build_cosy_pipeline of a checkpoint the exporter wrote "
          f"(bf16), greedy pool: card vs CPU tokens identical {same}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(same, f"cosy serve small: launcher pools differ: card {toks[str(dev)]} cpu {toks['cpu']}")


class _StreamReader:
    """A POST whose answer is a chunked WAV, read from a raw socket as it
    arrives: the seconds to the first PCM chunk and to the 0-chunk, the
    PCM bytes, the number of PCM chunks and each one's (seconds, bytes) as
    it arrived."""

    def __init__(self, port: int, body: dict):
        self.port, self.body = port, body
        self.ttfa = self.wall = None
        self.pcm, self.chunks, self.status, self.arrivals = b"", 0, None, []

    def __call__(self):
        import socket

        data = json.dumps(self.body).encode()
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", self.port), timeout=900) as s:
            s.sendall(b"POST /api/rwkv_tts_stream HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += s.recv(65536)
            head, buf = buf.split(b"\r\n\r\n", 1)
            self.status = head.split(b"\r\n")[0].decode()
            first = True
            while True:
                while b"\r\n" not in buf:
                    buf += s.recv(65536)
                size, buf = buf.split(b"\r\n", 1)
                n = int(size, 16)
                while len(buf) < n + 2:
                    buf += s.recv(65536)
                part, buf = buf[:n], buf[n + 2:]
                if n == 0:
                    break
                if first:
                    first = False  # the WAV header
                    continue
                if self.ttfa is None:
                    self.ttfa = time.perf_counter() - t0
                self.arrivals.append((time.perf_counter() - t0, n))
                self.pcm += part
                self.chunks += 1
        self.wall = time.perf_counter() - t0


def phase_cosy_serve_main(dev, card: str) -> dict:
    """The Cosy server at the 1.5B pairing (path cosy-1.5B-serve-8): a
    random Cosy LM 2048 x 24 through launch.cosy_pipeline with
    FlowConfig(sfm=True) / HiFTConfig() / S3TokenizerConfig() /
    CampplusConfig() random codecs, CosyTTSService
    (8 slots, chunk 16, RAS 25 / 0.8, hop 50) behind HTTP: 8 concurrent
    streams with 6 s prompt wavs under the bench's 400-token cap; then, at
    100 tokens, the same 8 voices stored (under torch.profiler: the card's
    busy share and the host's synchronising calls), one solo stream, 4
    non-streaming requests and one mp3; then the SFM levers (sfm, 5 steps,
    ctx 50, vocode every 2) on 8 stored-voice streams. Each flow hop, HiFT
    call and pool step is timed on the wall and on its thread's CPU."""
    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import flow, hift
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.infer.voices import CosyVoiceLibrary
    from rwkvtts_torch.models import cosy
    from rwkvtts_torch.serving import launch

    L, N = COSY_L, SERVE_COSY_STREAMS
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = t_phase = time.perf_counter()
    cfg = cosy.default_config(hidden_size=COSY_C, num_layers=L)
    g = torch.Generator(device=dev).manual_seed(0)
    params = cosy.init_params(g, cfg)
    randomize(params, g)
    gen_dev = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    fcfg, hcfg = flow.FlowConfig(sfm=True), hift.HiFTConfig()
    s3cfg, ccfg = s3.S3TokenizerConfig(), cp.CampplusConfig()
    # the launcher's pipeline of these weights (phase 22 loads one from a
    # checkpoint file through launch.build_cosy_pipeline)
    pipe = launch.cosy_pipeline(
        cfg, params, dev, flow_cfg=fcfg, flow_params=flow.init_params(gen_dev(1), fcfg),
        hift_cfg=hcfg, hift_params=hift.init_params(gen_dev(2), hcfg), s3_cfg=s3cfg,
        s3_params=s3.init_params(gen_dev(3), s3cfg), campplus_cfg=ccfg,
        campplus_params=cp.init_params(gen_dev(4), ccfg))
    del params
    torch.cuda.synchronize()
    att = pipe.lm_params["blocks"]["att"]
    check(pipe.lm_mega is None and "fused_a" in att and att["fused_a"].dtype == torch.bfloat16,
          "cosy serve main: not the launcher's pipeline (fused bf16 decode weights)")
    print(f"cosy serve main: Cosy {COSY_C} x {L} random weights through launch.cosy_pipeline "
          f"with random FlowConfig(sfm=True) / HiFTConfig() / S3TokenizerConfig() / "
          f"CampplusConfig() in {time.perf_counter() - t0:.1f} s")

    clips = [prompt_clip(ZS_PROMPT_S, seed=10 + i) for i in range(N)]
    with tempfile.TemporaryDirectory() as vdir:
        voices = CosyVoiceLibrary(vdir)
        for i, c in enumerate(clips):
            voices.register_from_wav(pipe, f"v{i}", c)
        out = _cosy_serve_traffic(card, pipe, voices, clips, start_bytes)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"cosy serve main: the phase took {out['phase_s']:.1f} s")
    return out


def trace_numbers(prof, wall_s: float, kernels: str = "") -> dict:
    """From a torch.profiler run with CUDA activity: the device's busy
    share (the union of its kernel, copy and fill intervals over `wall_s`)
    and the host's synchronizing CUDA calls (their count and the
    milliseconds the calling threads spent in them); with `kernels`, the
    device ms a launch of each kernel whose name holds it (read from the
    same events, without ``key_averages``)."""
    import collections

    spans, syncs = [], collections.Counter()
    sync_ms = 0.0
    picked = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        dt, name = e.device_type(), e.name()
        if getattr(dt, "name", str(dt)).endswith("CUDA"):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            if kernels and kernels in name:
                picked[name][0] += e.duration_ns() / 1e6
                picked[name][1] += 1
        elif "Synchronize" in name or name == "cudaMemcpy":
            syncs[name] += 1
            sync_ms += e.duration_ns() / 1e6
    spans.sort()
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a >= end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    out = {"device_busy_share": busy_ns / 1e9 / wall_s, "device_busy_s": busy_ns / 1e9,
           "device_ops": len(spans), "syncs": dict(syncs), "sync_ms": sync_ms}
    if kernels:
        out["device_ms_a_launch"] = {k[:60]: t / n for k, (t, n) in picked.items()}
    return out


def _cosy_serve_traffic(card, pipe, voices, clips, start_bytes) -> dict:
    """Phase 23's traffic on a built pipeline and its stored voices: 8
    streams with prompt wavs at the bench's cap (SERVE_COSY_NEW tokens);
    then, capped at SERVE_COSY_SHORT, 8 stored-voice streams under
    torch.profiler, one solo stream, 4 non-streaming requests and an mp3;
    then the SFM levers."""
    import collections
    import base64
    import threading
    import urllib.request

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rwkvtts_torch.infer import streaming
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving import http_server, launch
    from rwkvtts_torch.serving import service as svc
    from rwkvtts_torch.utils import mp3

    L, N = COSY_L, SERVE_COSY_STREAMS
    up = pipe.flow_cfg.token_mel_ratio * pipe.hift_cfg.total_upsample  # samples a token
    text = "The quick brown fox jumped over the lazy dog near the river."
    check(len(text) == SERVE_COSY_TEXT, "cosy serve main: text length")
    wav_b64 = [base64.b64encode(svc.wav_bytes(c, 16000)).decode() for c in clips]

    # what the server did, from its own side: wav finite, tokens a request,
    # pool chunk and admission times, flow and HiFT hop times; each time as
    # (wall seconds, seconds the calling thread ran on a CPU)
    rec = {"finite": True, "tokens": {}, "step_s": [], "admit": 0, "flow_s": [], "hift_s": [],
           "lock": threading.Lock()}
    pcm16, wav_bytes = svc.pcm16, svc.wav_bytes

    def finite_pcm(w):
        rec["finite"] &= bool(np.isfinite(w).all())
        return pcm16(w)

    def finite_wav(w, sr):
        rec["finite"] &= bool(np.isfinite(w).all())
        return wav_bytes(w, sr)

    def timed(name, fn):
        def wrapped(*a, **kw):
            t, c = time.perf_counter(), time.thread_time()
            out = fn(*a, **kw)
            with rec["lock"]:
                rec[name].append((time.perf_counter() - t, time.thread_time() - c))
            return out
        return wrapped

    flow_hop, hift_hop = streaming._flow_hop, streaming._hift_hop
    svc.pcm16, svc.wav_bytes = finite_pcm, finite_wav
    streaming._flow_hop, streaming._hift_hop = timed("flow_s", flow_hop), timed("hift_s", hift_hop)

    def instrument(tts):
        b = tts.hub.batcher
        step, process, prefill = b.step, b._process, b._prefill

        def timed_step():
            t, c = time.perf_counter(), time.thread_time()
            out = step()
            if b._pending is not None or out:
                rec["step_s"].append((time.perf_counter() - t, time.thread_time() - c))
            return out

        def counted_process(toks, owners):
            events = process(toks, owners)
            for rid, new, done in events:
                rec["tokens"][rid] = rec["tokens"].get(rid, 0) + len(new)
            return events

        def counted_prefill(batch):
            rec["admit"] += 1
            return prefill(batch)

        b.step, b._process, b._prefill = timed_step, counted_process, counted_prefill

    def reset():
        torch.cuda.synchronize()
        for k in ("step_s", "flow_s", "hift_s"):
            rec[k].clear()
        rec["tokens"].clear()
        rec["admit"] = 0
        sp.reset_launches()
        wkv7_cuda.reset_launches()

    def burst(port, bodies):
        readers = [_StreamReader(port, b) for b in bodies]
        threads = [threading.Thread(target=r) for r in readers]
        t0, c0 = time.perf_counter(), time.process_time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        cpu_share = (time.process_time() - c0) / wall
        bad = [r.status for r in readers if "200" not in (r.status or "")]
        check(not bad, f"cosy serve main: stream answers {bad}")
        samples = [len(r.pcm) // 2 for r in readers]
        check(all(n > 0 and n % up == 0 for n in samples),
              f"cosy serve main: stream samples {samples}, want a multiple of {up}")
        audio = [n / pipe.sample_rate for n in samples]
        # after the first chunk: the gaps between chunks, and each stream's
        # seconds from its first chunk to its last over the audio after
        # the first chunk (below 1: the stream keeps up once it plays)
        gaps = [b[0] - a[0] for r in readers for a, b in zip(r.arrivals, r.arrivals[1:])]
        steady = [(r.arrivals[-1][0] - r.arrivals[0][0])
                  / (sum(n for _, n in r.arrivals[1:]) / 2 / pipe.sample_rate)
                  for r in readers if len(r.arrivals) > 1]
        return {"ttfa_ms": sorted(1e3 * r.ttfa for r in readers), "wall_s": wall,
                "rtf": [r.wall / a for r, a in zip(readers, audio)],
                "aggregate_realtime_x": sum(audio) / wall, "audio_s": sum(audio),
                "chunks": sum(r.chunks for r in readers), "samples": samples,
                "gap_ms_median": 1e3 * float(np.median(gaps)) if gaps else None,
                "steady_rtf_median": float(np.median(steady)) if steady else None,
                "cpu_share": cpu_share}

    def pool_numbers(samples):
        toks = collections.Counter(rec["tokens"].values())
        check(not collections.Counter(n // up for n in samples) - toks,
              f"cosy serve main: samples {sorted(samples)} for tokens {sorted(toks.elements())}"
              f" ({up} samples a token)")
        steps = SERVE_COSY_CHUNK * len(rec["step_s"])
        launches = {"wkv7_step": sp.launches, "wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"]}
        per_step = launches["wkv7_step"] / max(steps, 1)
        per_admit = launches["wkv7_fwd"] / max(rec["admit"], 1)
        check(per_step == L, f"cosy serve main: wkv7_step {launches['wkv7_step']} over {steps} "
                             f"pool steps, want {L} a step")
        check(per_admit == L, f"cosy serve main: wkv7_fwd {launches['wkv7_fwd']} over "
                              f"{rec['admit']} admissions, want {L} an admission")
        wall = {k: sum(w for w, _ in rec[k]) for k in ("step_s", "flow_s", "hift_s")}
        cpu = {k: sum(c for _, c in rec[k]) for k in ("step_s", "flow_s", "hift_s")}
        lm, fl, hf = wall["step_s"], wall["flow_s"], wall["hift_s"]
        per = lambda d, k: 1e3 * d[k] / max(len(rec[k]), 1)
        return {"pool_ms_per_chunk": per(wall, "step_s"),
                "pool_ms_per_step": 1e3 * lm / max(steps, 1),
                "pool_cpu_ms_per_step": 1e3 * cpu["step_s"] / max(steps, 1),
                "pool_steps": steps, "admissions": rec["admit"], "wkv7_step_per_step": per_step,
                "wkv7_fwd_per_admission": per_admit, "launches": launches,
                "lm_s": lm, "flow_s": fl, "hift_s": hf,
                "lm_share": lm / (lm + fl + hf), "flow_share": fl / (lm + fl + hf),
                "hift_share": hf / (lm + fl + hf), "flow_hops": len(rec["flow_s"]),
                "flow_ms_per_hop": per(wall, "flow_s"), "flow_cpu_ms_per_hop": per(cpu, "flow_s"),
                "hift_ms_per_call": per(wall, "hift_s"),
                "hift_cpu_ms_per_call": per(cpu, "hift_s")}

    kw = dict(voices=voices, n_slots=N, chunk=SERVE_COSY_CHUNK, top_k=25, top_p=0.8)
    stream_body = lambda i, **x: {"text": text, "seed": i, "hop_tokens": SERVE_COSY_HOP, **x}

    def serve(cap, **extra):
        tts = svc.CosyTTSService(pipe, max_new_tokens=cap, **kw, **extra)
        instrument(tts)
        return (tts, *http_server.start_background(tts))

    def stop(tts, server):
        server.shutdown()
        server.server_close()
        tts.close()

    def warm(tts):
        """One short stream on this thread before the SFM levers' traffic
        (their flow decode runs here first at these widths)."""
        req = svc.TTSRequest(text=text, speaker="v0", seed=0, max_new_tokens=SERVE_COSY_SHORT)
        check(len(list(tts.stream(req, hop_tokens=SERVE_COSY_HOP))) > 0,
              "cosy serve main: the warm-up stream gave no audio")

    def line(name, r):
        print(f"cosy serve main: {name}: {len(r['samples'])} streams, TTFA p50 "
              f"{np.percentile(r['ttfa_ms'], 50):.1f} ms, p95 "
              f"{np.percentile(r['ttfa_ms'], 95):.1f} ms, RTF a stream "
              f"{np.median(r['rtf']):.4f} (median), aggregate {r['aggregate_realtime_x']:.3f}"
              f" x realtime, {r['audio_s']:.2f} s of audio in {r['wall_s']:.3f} s, "
              f"{r['chunks']} chunks; after the first chunk: {r['gap_ms_median']} ms between "
              f"chunks (median), {r['steady_rtf_median']} s a second of audio (median); "
              f"process CPU {r['cpu_share']:.3f} of the wall")

    def pool_line(name, x):
        print(f"cosy serve main: {name}: pool {x['pool_ms_per_step']:.3f} ms a step "
              f"({x['pool_cpu_ms_per_step']:.3f} ms of it on the pump thread's CPU), "
              f"{x['pool_ms_per_chunk']:.2f} ms a chunk over {x['pool_steps']} steps; "
              f"{x['admissions']} admissions; launches {x['launches']} = "
              f"{x['wkv7_step_per_step']:.0f} a step, {x['wkv7_fwd_per_admission']:.0f} an "
              f"admission; LM / flow / HiFT busy {x['lm_s']:.2f} / {x['flow_s']:.2f} / "
              f"{x['hift_s']:.2f} s; flow {x['flow_ms_per_hop']:.1f} ms a hop "
              f"({x['flow_cpu_ms_per_hop']:.1f} ms on its thread's CPU, {x['flow_hops']} hops), "
              f"HiFT {x['hift_ms_per_call']:.1f} ms a call ({x['hift_cpu_ms_per_call']:.1f} "
              f"ms CPU)")

    summ = lambda r: {k: r[k] for k in ("aggregate_realtime_x", "audio_s", "wall_s",
                                        "gap_ms_median", "steady_rtf_median", "cpu_share")} | {
        "ttfa_ms_p50": float(np.percentile(r["ttfa_ms"], 50)),
        "ttfa_ms_p95": float(np.percentile(r["ttfa_ms"], 95)),
        "rtf_median": float(np.median(r["rtf"]))}
    try:
        # the bench's traffic: 8 streams with 6 s prompt wavs under its cap
        # (the flow and HiFT ran at these widths in phases 11 and 21)
        tts, server, port = serve(SERVE_COSY_NEW, warmup=True, warmup_widths=[128, 256])
        try:
            reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pooled = burst(port, [stream_body(i, audio=wav_b64[i]) for i in range(N)])
            numbers = pool_numbers(pooled["samples"])
        finally:
            stop(tts, server)
        line(f"pooled, 6 s prompt wavs, {SERVE_COSY_NEW} tokens", pooled)
        pool_line("pooled, 6 s prompt wavs", numbers)

        # capped at SERVE_COSY_SHORT: stored voices under the profiler, solo,
        # 4 non-streaming requests, an mp3
        tts, server, port = serve(SERVE_COSY_SHORT, warmup=True, warmup_widths=[128, 256])
        try:
            reset()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                stored = burst(port, [stream_body(i, speaker=f"v{i}") for i in range(N)])
                torch.cuda.synchronize()
            stored_numbers = pool_numbers(stored["samples"])
            trace = trace_numbers(prof, stored["wall_s"])
            del prof
            reset()
            solo = burst(port, [stream_body(0, speaker="v0")])
            solo_numbers = pool_numbers(solo["samples"])
            reset()

            answers = [None] * 4

            def post(i, fmt="wav"):
                body = json.dumps({"text": text, "speaker": f"v{i}", "seed": i,
                                   "audio_format": fmt}).encode()
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{port}/api/rwkv_tts", data=body,
                        headers={"Content-Type": "application/json"}), timeout=900) as r:
                    return r.status, r.headers["Content-Type"], r.read()

            threads = [threading.Thread(target=lambda i=i: answers.__setitem__(i, post(i)))
                       for i in range(4)]
            t1 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            plain_s = time.perf_counter() - t1
            wav_samples = []
            for code, ctype, body in answers:
                check((code, ctype) == (200, "audio/wav") and body[:4] == b"RIFF",
                      f"cosy serve main: /api/rwkv_tts answered {code} {ctype}")
                wav_samples.append((len(body) - 44) // 2)
            check(all(n > 0 and n % up == 0 for n in wav_samples),
                  f"cosy serve main: wav samples {wav_samples}")
            if mp3.available():
                code, ctype, body = post(0, "mp3")
                check((code, ctype) == (200, "audio/mpeg") and body[0] == 0xFF,
                      f"cosy serve main: mp3 answered {code} {ctype}")
                mp3_note = f"mp3 {len(body)} bytes"
            else:
                mp3_note = "mp3 skipped (no libmp3lame on this host)"
            pool_numbers(wav_samples)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            total_s = time.perf_counter() - t0
        finally:
            stop(tts, server)
        check(rec["finite"], "cosy serve main: a wav is not finite")
        line(f"pooled, stored voices, {SERVE_COSY_SHORT} tokens, under torch.profiler", stored)
        pool_line("pooled, stored voices", stored_numbers)
        print(f"cosy serve main: the stored-voice burst's trace: device busy "
              f"{trace['device_busy_s']:.3f} s of {stored['wall_s']:.3f} s "
              f"({trace['device_busy_share']:.3f}), {trace['device_ops']} device ops; "
              f"synchronizing calls {trace['syncs']}, {trace['sync_ms']:.1f} ms spent in them over "
              f"{stored_numbers['flow_hops']} flow hops and "
              f"{stored_numbers['pool_steps'] // SERVE_COSY_CHUNK} pool chunks")
        line(f"solo, a stored voice, {SERVE_COSY_SHORT} tokens", solo)
        pool_line("solo", solo_numbers)
        print(f"cosy serve main: 4 /api/rwkv_tts answers in {plain_s:.3f} s ({wav_samples} "
              f"samples), {mp3_note}; peak memory {peak / 2**30:.2f} GiB "
              f"({(peak - start_bytes) / 2**30:.2f} over what the phase started with); "
              f"{total_s:.1f} s of traffic on {card}")
        out = {"pooled_wav_prompt": summ(pooled), "pooled_stored": summ(stored),
               "solo": summ(solo), "trace_stored": trace, "plain_4_s": plain_s,
               "mp3": mp3.available(), "wav_finite": rec["finite"], "samples_a_token": up,
               "peak_gib": peak / 2**30, "peak_over_start_gib": (peak - start_bytes) / 2**30,
               "solo_pool_ms_per_step": solo_numbers["pool_ms_per_step"],
               "solo_flow_ms_per_hop": solo_numbers["flow_ms_per_hop"], **numbers}

        # the SFM levers: sfm, 5 flow steps, ctx 50, vocode every 2
        scfg = launch.stream_config(sfm=True, flow_timesteps=5, stream_ctx=50, vocode_every=2)
        tts, server, port = serve(SERVE_COSY_SHORT, warmup=False, stream_cfg=scfg)
        try:
            warm(tts)
            reset()
            sfm = burst(port, [stream_body(i, speaker=f"v{i}") for i in range(N)])
            sfm_numbers = pool_numbers(sfm["samples"])
        finally:
            stop(tts, server)
        check(rec["finite"], "cosy serve main: an SFM wav is not finite")
        line(f"SFM levers ({scfg}), stored voices, {SERVE_COSY_SHORT} tokens", sfm)
        pool_line("SFM levers", sfm_numbers)
        out["sfm"] = summ(sfm) | {k: sfm_numbers[k] for k in (
            "flow_ms_per_hop", "flow_cpu_ms_per_hop", "hift_ms_per_call", "pool_ms_per_step",
            "lm_share", "flow_share", "hift_share")}
    finally:
        svc.pcm16, svc.wav_bytes = pcm16, wav_bytes
        streaming._flow_hop, streaming._hift_hop = flow_hop, hift_hop
    return out


def cosy_serve_of_tree(what: str = "cosy serve") -> dict:
    """Phases 22-23 alone (the Cosy pool card vs CPU and the SFM hop, then
    the Cosy server at the 1.5B pairing) with whichever rwkvtts_torch is
    imported, TF32 off; prints their numbers as one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    phase_cosy_serve_small(dev)
    out = phase_cosy_serve_main(dev, card)
    print(f"{what}: " + json.dumps({k: v for k, v in out.items() if k != "launches"}))
    return out


# ---------------------------------------------------------------------------
# 24-25. XY/Higgs text->wav: the 8-channel LM on both backbone routes and
# the two codecs, small on the card vs the CPU, then the paths at full width
# ---------------------------------------------------------------------------

# then XYPipeline.synthesize at B = 1 with XYTokenizerConfig(), a
# decode_long of 40 s, a 6 s encode and a Higgs decode at HiggsConfig()
XY_SYNTH_NEW, XY_LONG_CODES, XY_CLIP_S, HIGGS_FRAMES = 256, 500, 6.0, 256
# phase 24's LM vocabularies (tests/test_decode_mega_b64.py:222-229) and codecs
XY_SMALL_VOCAB = dict(text_vocab_size=700, speech_vocab_size=32, text_shift_size=600)
XY_SMALL_CODEC = dict(n_mels=16, d_model=32, enc_layers=1, heads=2, ffn_dim=64, adapter_layers=1,
                      nq=8, codebook_size=16, codebook_dim=8, rvq_dim=16,
                      quantizer_io_dim=128, dec_layers=1, vocos_dim=32,
                      vocos_intermediate_dim=64, vocos_layers=1, vocos_n_fft=64, vocos_hop=16)
HIGGS_SMALL = dict(d_model=8, latent_dim=16, semantic_dim=16, nq=8, codebook_size=16,
                   strides=(2, 2, 2), decoder_channels=16)


def xy_launches() -> dict:
    """Kernels 2, 1 and 7's launch counts since their last reset."""
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp

    return {"wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"], "decode_b64_step": dmb.launches,
            "wkv7_step": sp.launches}


def reset_xy_launches() -> None:
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp

    wkv7_cuda.reset_launches()
    dmb.reset_launches()
    sp.reset_launches()


def xy_prompt(g: torch.Generator, Bn: int, T: int, cfg, lo: int, hi: int):
    """The bench's prompt: text ids in [lo, hi) on channel 0, zeros on the
    other channels, no padding."""
    ids = torch.zeros(Bn, T, cfg.num_channels, dtype=torch.long)
    ids[:, :, 0] = torch.randint(lo, hi, (Bn, T), generator=g)
    return ids, torch.ones(Bn, T, dtype=torch.int32)


def phase_xy_small(dev) -> None:
    """xy_generate at LM 128 x 2 (f32, the reduced vocabularies, heads x 10,
    temperature 0.01) on the rwkv7.decode_step route (B = 8) and on kernel 1
    (B = 64), card vs CPU on one set of noise: identical frames, and kernel
    7 L a step, kernel 1 8 L + 2 a frame, kernel 2 L a prefill; a tiny
    XY_Tokenizer and a tiny Higgs codec, card vs CPU: wav within 1e-4, the
    codes' share that agrees."""
    import dataclasses

    import numpy as np

    from rwkvtts_torch.codecs import higgs, nn
    from rwkvtts_torch.codecs import xy_tokenizer as xt
    from rwkvtts_torch.infer.generate import xy_generate
    from rwkvtts_torch.models import rwkv7, xy
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import sampling

    cfg = dataclasses.replace(xy.default_config(hidden_size=128, num_layers=2,
                                                dtype=torch.float32), **XY_SMALL_VOCAB)
    L, n_new = cfg.backbone.num_layers, 8
    g = torch.Generator().manual_seed(51)
    params = xy.init_params(g, cfg)
    randomize(params, g)
    params["heads"] = {k: 10.0 * v for k, v in params["heads"].items()}  # far from a near-tie
    widths = [cfg.text_vocab_size] + [cfg.speech_vocab_size] * (cfg.num_channels - 1)
    for route, Bn in (("decode_step", XY_B), ("kernel 1", B)):
        gn = torch.Generator().manual_seed(52)
        noise = [sampling.gumbel((n_new, Bn, w), gn) for w in widths]
        ids, mask = xy_prompt(gn, Bn, 6, cfg, 1, 500)
        out = {}
        for where in ("cpu", dev):
            p = rwkv7.tree_map(lambda t: t.to(where), params)
            mega = dmb.pack_mega_b64(p, cfg.backbone) if route == "kernel 1" else None
            reset_xy_launches()
            out[str(where)] = xy_generate(
                p, cfg, ids.to(where), mask.to(where), max_new_tokens=n_new, min_new_tokens=1,
                temperature=0.01, mega=mega, noise=[t.to(where) for t in noise])
            launches = xy_launches()
        (f_c, n_c), (f_g, n_g) = out["cpu"], out[str(dev)]
        diff = (f_g.cpu() != f_c).any(-1).nonzero().tolist()
        want = {"wkv7_fwd": L, "decode_b64_step": (8 * L + 2) * n_new if route == "kernel 1" else 0,
                "wkv7_step": L * n_new if route == "decode_step" else 0}
        print(f"xy small: LM 128 x 2 f32, {route} route, B={Bn}, {n_new} frames at temperature "
              f"0.01 on one set of noise: card vs CPU frames differ at (row, step) {diff}, "
              f"n_audio equal {bool((n_g.cpu() == n_c).all())}; card launches {launches} "
              f"(want {want})")
        check(not diff and bool((n_g.cpu() == n_c).all()),
              f"xy small: the {route} route on the card disagrees with the CPU")
        check(launches == want, f"xy small: {route} launches {launches}, want {want}")

    xcfg, hcfg = xt.XYTokenizerConfig(**XY_SMALL_CODEC), higgs.HiggsConfig(**HIGGS_SMALL)
    xp = xt.init_params(torch.Generator().manual_seed(53), xcfg)
    hp = higgs.init_params(torch.Generator().manual_seed(54), hcfg)
    gc = torch.Generator().manual_seed(55)
    codes = torch.randint(0, 16, (8, 2, 20), generator=gc)
    clip = torch.from_numpy(np.stack([prompt_clip(2.0, seed=s) for s in (2, 3)]))
    feats = torch.randn(2, 1600 // 8, 16, generator=gc)
    res = {}
    for where in ("cpu", dev):
        on = lambda tree: rwkv7.tree_map(lambda t: t.to(where), tree)
        xpw, hpw = on(xp), on(hp)
        with nn.f32():
            mel = xt.whisper_log_mel(clip.to(where), n_mels=xcfg.n_mels)
            res[str(where)] = [t.cpu() for t in (
                xt.decode(xpw, xcfg, codes.to(where)), xt.encode(xpw, xcfg, mel),
                higgs.decode(hpw, hcfg, codes.to(where)),
                higgs.encode(hpw, hcfg, clip[:, :1600].to(where), feats.to(where)))]
    (xw_c, xc_c, hw_c, hc_c), (xw_g, xc_g, hw_g, hc_g) = res["cpu"], res[str(dev)]
    e_x, e_h = rel(xw_g, xw_c), rel(hw_g, hw_c)
    s_x, s_h = (xc_g == xc_c).float().mean().item(), (hc_g == hc_c).float().mean().item()
    print(f"xy small: tiny XY_Tokenizer decode wav {tuple(xw_g.shape)} rel {e_x:.3e}, encode of "
          f"2 x 2 s codes {tuple(xc_g.shape)} {s_x:.4f} equal; tiny Higgs decode wav "
          f"{tuple(hw_g.shape)} rel {e_h:.3e}, encode codes {tuple(hc_g.shape)} {s_h:.4f} equal "
          f"(card vs CPU; wav limit 1e-4, codes limit 0.9)")
    check(e_x <= 1e-4 and e_h <= 1e-4 and s_x >= 0.9 and s_h >= 0.9,
          "xy small: a codec on the card disagrees with the CPU")


def phase_xy_main(dev, card: str) -> dict:
    """The paths xy-0.4B-b8 and xy-0.4B-b64 (an XY LM 1024 x 24, bf16,
    random from seed 0): a 32-token prompt, 256 frames with no EOS, on
    rwkv7.decode_step at B = 8 and on kernel 1 at B = 64 (int8, bf16
    carry); frames/s, tokens/s, audio x realtime, ms a frame, launches by
    kernel, peak memory. Then XYPipeline.synthesize at B = 1 with
    XYTokenizerConfig() (random weights), a decode_long of 40 s, a 6 s
    encode against the CPU's, and a Higgs decode at HiggsConfig()."""
    import numpy as np

    from rwkvtts_torch.codecs import higgs, nn
    from rwkvtts_torch.codecs import xy_tokenizer as xt
    from rwkvtts_torch.infer.generate import xy_generate
    from rwkvtts_torch.infer.xy_pipeline import XYPipeline, xy_text_tokenizer
    from rwkvtts_torch.models import rwkv7, xy
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    t0 = t_phase = time.perf_counter()
    cfg = xy.default_config(hidden_size=XY_C, num_layers=XY_L)
    L = XY_L
    params = xy.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, params)
    mega = dmb.pack_mega_b64(params, cfg.backbone)
    torch.cuda.synchronize()
    print(f"xy main: XY LM {XY_C} x {L} bf16 (8 tables and heads, channel 0 "
          f"{cfg.text_vocab_size} wide) and its int8 pack built in "
          f"{time.perf_counter() - t0:.1f} s")
    out: dict = {"paths": {}}
    for path, Bn, m in (("xy-0.4B-b8", XY_B, None), ("xy-0.4B-b64", B, mega)):
        def run(seed, frames):
            g = torch.Generator().manual_seed(seed)
            ids, mask = xy_prompt(g, Bn, XY_PROMPT, cfg, 100, 60000)
            return xy_generate(params, cfg, ids.to(dev), mask.to(dev), max_new_tokens=frames,
                               min_new_tokens=frames, allow_eos=False, mega=m,
                               generator=torch.Generator(device=dev).manual_seed(seed))

        run(1, 16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        reset_xy_launches()
        t0 = time.perf_counter()
        frames, n_audio = run(2, XY_FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, by_kernel = xy_launches(), dict(dmb.kernel_launches)
        peak = torch.cuda.max_memory_allocated()
        fps = Bn * XY_FRAMES / seconds
        r = {"B": Bn, "seconds": seconds, "frames_per_s": fps, "tokens_per_s": 8 * fps,
             "audio_x_realtime": fps / 12.5, "ms_a_frame": 1e3 * seconds / XY_FRAMES,
             "launches": launches, "peak_gib": peak / 2**30,
             "peak_over_start_gib": (peak - start_bytes) / 2**30}
        if m is not None:
            r["by_kernel"] = by_kernel
        out["paths"][path] = r
        want = {"wkv7_fwd": L, "decode_b64_step": (8 * L + 2) * XY_FRAMES if m is not None else 0,
                "wkv7_step": L * XY_FRAMES if m is None else 0}
        ch0 = frames[..., 0]
        lo = cfg.text_shift_size
        print(f"xy main: {path}: B={Bn}, {XY_PROMPT} + {XY_FRAMES} frames: {seconds:.4f} s, "
              f"{fps:.1f} frames/s, {8 * fps:.1f} tokens/s, {fps / 12.5:.1f} x realtime, "
              f"{1e3 * seconds / XY_FRAMES:.4f} ms a frame (sampling and prefill in) on {card}; "
              f"launches {launches}" + (f", by kernel {by_kernel}" if m is not None else "")
              + f"; peak memory {peak / 2**30:.2f} GiB, {(peak - start_bytes) / 2**30:.2f} over "
              f"what the run started with")
        check(frames.shape == (Bn, XY_FRAMES, 8) and bool((n_audio == XY_FRAMES).all()),
              f"xy main: {path} frames {tuple(frames.shape)}, n_audio {n_audio.tolist()}")
        check(bool(((ch0 >= lo) & (ch0 < lo + cfg.speech_vocab_size)).all())
              and bool(((frames[..., 1:] >= 0) & (frames[..., 1:] < cfg.speech_vocab_size)).all()),
              f"xy main: {path} drew a token out of its channel's range")
        check(launches == want, f"xy main: {path} launches {launches}, want {want}")
    del mega
    torch.cuda.empty_cache()

    # XYPipeline.synthesize at B = 1, the codec at its published widths
    t0 = time.perf_counter()
    xcfg = xt.XYTokenizerConfig()
    xp = xt.init_params(torch.Generator(device=dev).manual_seed(1), xcfg)
    pipe = XYPipeline(cfg, params, xy_text_tokenizer(), xcfg, xp, device=dev)
    torch.cuda.synchronize()
    n_codec = sum(t.numel() for t in _leaves(xp))
    print(f"xy main: XY_Tokenizer {n_codec / 1e6:.1f} M random parameters (seed 1) and the "
          f"pipeline built in {time.perf_counter() - t0:.1f} s")
    text = XY_TEXT
    n_prompt = len(pipe.tok.encode(f"[S{pipe.speaker_id}]{text}[CTL0]"))
    check(n_prompt == XY_SYNTH_PROMPT,
          f"xy main: the utterance's prompt is {n_prompt} tokens; phase 3 holds kernel 2 "
          f"at {XY_SYNTH_PROMPT}")
    # the first call at the utterance's shapes (the codec's cold), then the
    # same utterance again (warm), timed and counted
    cold = pipe.synthesize(text, max_new_tokens=XY_SYNTH_NEW, seed=4)
    torch.cuda.synchronize()
    reset_xy_launches()
    res = pipe.synthesize(text, max_new_tokens=XY_SYNTH_NEW, seed=4)
    launches = xy_launches()
    T = res.codes.shape[1]
    audio_s = T / xcfg.frame_rate
    synth = {"codes": T, "audio_s": audio_s, "llm_s": res.llm_s, "codec_s": res.codec_s,
             "codec_ms_per_audio_s": 1e3 * res.codec_s / max(audio_s, 1e-9),
             "cold_llm_s": cold.llm_s, "cold_codec_s": cold.codec_s,
             "sample_rate": res.sample_rate, "launches": launches}
    print(f"xy main: XYPipeline.synthesize B=1, {XY_SYNTH_NEW} steps: {T} codes ({audio_s:.2f} s "
          f"of audio), LM {res.llm_s:.3f} s ({1e3 * res.llm_s / XY_SYNTH_NEW:.2f} ms a step), "
          f"codec {res.codec_s:.3f} s ({synth['codec_ms_per_audio_s']:.2f} ms per audio s); "
          f"the first call at these shapes LM {cold.llm_s:.3f} s, codec {cold.codec_s:.3f} s; "
          f"wav {res.wav.shape} at {res.sample_rate} Hz; launches {launches} on {card}")
    check(np.array_equal(cold.codes, res.codes), "xy main: one seed gave two utterances")
    check(T > 0 and _wav_ok(res.wav, T, 8 * xcfg.vocos_hop) and res.sample_rate == 24000,
          f"xy main: synthesize wav {res.wav.shape} for {T} codes")
    check(launches == {"wkv7_fwd": L, "decode_b64_step": 0, "wkv7_step": L * XY_SYNTH_NEW},
          f"xy main: synthesize launches {launches}, want {L} and {L} a step")
    out["synthesize"] = synth

    codes = np.random.default_rng(5).integers(0, xcfg.codebook_size, (xcfg.nq, XY_LONG_CODES))
    with nn.f32():
        xt.decode(xp, xcfg, torch.from_numpy(codes[:, None, :30]).to(dev))  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = xt.decode_long(xp, xcfg, codes)
        long_s = time.perf_counter() - t0
    long_audio = XY_LONG_CODES / xcfg.frame_rate
    out["decode_long"] = {"codes": XY_LONG_CODES, "seconds": long_s,
                          "ms_per_audio_s": 1e3 * long_s / long_audio}
    print(f"xy main: decode_long of {XY_LONG_CODES} codes ({long_audio:.1f} s, 2 windows of 30 s): "
          f"{long_s:.3f} s, {1e3 * long_s / long_audio:.2f} ms per audio s, wav {wav.shape}")
    check(_wav_ok(wav, XY_LONG_CODES, 8 * xcfg.vocos_hop), f"xy main: decode_long wav {wav.shape}")

    clip = torch.from_numpy(prompt_clip(XY_CLIP_S, seed=4))[None]
    with nn.f32():
        enc = lambda p, where: xt.encode(p, xcfg, xt.whisper_log_mel(clip.to(where),
                                                                     n_mels=xcfg.n_mels))
        enc(xp, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes_g = enc(xp, dev).cpu()
        enc_ms = 1e3 * (time.perf_counter() - t0)
        codes_c = enc(rwkv7.tree_map(lambda t: t.cpu(), xp), "cpu")
    share = (codes_g == codes_c).float().mean().item()
    out["encode"] = {"seconds_of_audio": XY_CLIP_S, "ms": enc_ms, "codes": list(codes_g.shape),
                     "share_equal_cpu": share}
    print(f"xy main: encode of a {XY_CLIP_S:.0f} s clip: {enc_ms:.2f} ms, codes "
          f"{tuple(codes_g.shape)}, {share:.4f} equal to the CPU's (limit 0.9)")
    check(codes_g.shape == (xcfg.nq, 1, int(XY_CLIP_S * 12.5)) and share >= 0.9,
          "xy main: the XY encode on the card disagrees with the CPU")
    del pipe, xp
    torch.cuda.empty_cache()

    hcfg = higgs.HiggsConfig()
    hp = higgs.init_params(torch.Generator(device=dev).manual_seed(2), hcfg)
    hcodes = torch.randint(0, hcfg.codebook_size, (hcfg.nq, 1, HIGGS_FRAMES),
                           generator=torch.Generator().manual_seed(6)).to(dev)
    with nn.f32():
        higgs.decode(hp, hcfg, hcodes[:, :, :25])  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hwav = higgs.decode(hp, hcfg, hcodes)
        torch.cuda.synchronize()
        h_s = time.perf_counter() - t0
    h_audio = HIGGS_FRAMES / hcfg.frame_rate
    out["higgs_decode"] = {"frames": HIGGS_FRAMES, "seconds": h_s,
                           "ms_per_audio_s": 1e3 * h_s / h_audio}
    print(f"xy main: Higgs decode at HiggsConfig() of {HIGGS_FRAMES} frames ({h_audio:.2f} s): "
          f"{1e3 * h_s:.2f} ms, {1e3 * h_s / h_audio:.2f} ms per audio s, wav "
          f"{tuple(hwav.shape)}")
    check(hwav.shape == (1, HIGGS_FRAMES * hcfg.hop_length) and bool(torch.isfinite(hwav).all()),
          f"xy main: Higgs wav {tuple(hwav.shape)}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"xy main: the phase took {out['phase_s']:.1f} s")
    return out


def xy_of_tree(what: str = "xy") -> dict:
    """Phases 24-25 alone (the XY slice small on card vs CPU, then its paths
    at full width) with whichever rwkvtts_torch is imported, TF32 off;
    prints their numbers as one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    phase_xy_small(dev)
    out = phase_xy_main(dev, card)
    print(f"{what}: " + json.dumps(out))
    return out


# the ASR, S2S and two-tower paths (benchmarks/bench_families_scale.py:29-70,
# 157-220): asr-0.4B-whisper-large-v3 (an ASR LLM 1024 x 24 with a 1024 x 6
# adapter and the whisper-large-v3 encoder, B = 8 rows of 30 s, 16
# instruction and 4 hint tokens, 32 greedy new tokens), s2s-0.4B-b32 (B = 32,
# a 64-token prompt, 256 new tokens on the audio head, top-k 50 / top-p 0.95)
# and two-tower-0.4B-b16 (two 1024 x 24 towers, B = 16, a 64-token prompt, 256
# new tokens at generate's defaults); the warm-up calls decode ASR_WARM_NEW
ASR_C, ASR_L, ASR_ADAPTER_L = 1024, 24, 6
ASR_B, ASR_SECONDS, ASR_INSTR, ASR_HINTS, ASR_NEW = 8, 30.0, 16, 4, 32
WHISPER_LARGE_V3 = dict(n_mels=128, d_model=1280, layers=32, heads=20, ffn_dim=5120)
S2S_B, TT_B, S2S_PROMPT, S2S_NEW, ASR_WARM_NEW = 32, 16, 64, 256, 16
ASR_FRAMES = int(ASR_SECONDS * 50)  # the encoder's 50 Hz frames of a row
# kernel 2's shapes on these paths (name, B, T, H, saving) and kernel 7's (B, H)
ASR_WKV_SHAPES = (("asr adapter", ASR_B, ASR_FRAMES, ASR_C // 64, False),
                  ("asr llm", ASR_B, ASR_INSTR + ASR_FRAMES + ASR_HINTS, ASR_C // 64, False),
                  ("s2s prefill", S2S_B, S2S_PROMPT, ASR_C // 64, False),
                  ("two-tower prefill", TT_B, S2S_PROMPT, ASR_C // 64, False))
ASR_STEP_SHAPES = (("asr", ASR_B, ASR_C // 64), ("s2s", S2S_B, ASR_C // 64),
                   ("two-tower", TT_B, ASR_C // 64))


def wkv7_step_times(shapes, reps: int = 10, L: int = 24) -> dict:
    """Kernel 7 as rwkv7.decode_step runs it on these paths (a fresh state
    buffer, f32 carry, bf16 vectors) at (B, H) of `shapes`, one launch a
    layer over L layers' states, as a step meets them (each cold in L2
    when its turn comes): device ms a launch (torch.profiler), ms a launch
    on CUDA events, the plain step's ms and the bound (the state read and
    written, the six vectors read and y written; 7 operations an element
    of the state at the f32 rate)."""
    from rwkvtts_torch.ops import wkv7_step_packed as sp

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for name, Bn, H in shapes:
        states = [torch.zeros(Bn, H, 64, 64, device=dev) for _ in range(L)]
        vecs = step_inputs(g, Bn, H, torch.bfloat16)

        def kernel():
            for st in states:
                sp.wkv7_step_packed(st, *vecs, inplace=False)

        def plain():
            for st in states:
                sp.wkv7_step_plain(st, *vecs, inplace=False)

        ms, dms = cuda_ms(kernel, reps) / L, device_ms(kernel, "step_kernel", reps, L)
        plain_ms = cuda_ms(plain, 2) / L
        bms, by = bound_ms(2 * nbytes(states[0]) + 7 * nbytes(vecs[0]), 7 * Bn * H * 4096,
                           F32_FLOPS)
        out[name] = {"B": Bn, "H": H, "device_ms": dms, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by}
        print(f"wkv7 step: {name} ({Bn}, {H}), f32 carry, bf16 vectors, fresh state, over "
              f"{L} layers' states: device {dms:.4f} ms a launch, {ms:.4f} ms a launch on "
              f"events, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return out


def phase_asr_small(dev) -> dict:
    """Kernels 2 and 7 at the ASR, S2S and two-tower shapes against their
    plain versions (kernel 2 with a left-padded mask from right_align_pack:
    v zero at the pads), with their times and bounds; then tiny f32 configs
    (LM 128 x 2, heads x 10) of both ASR variants, S2S on both heads and the
    two-tower model, card vs CPU: greedy tokens, and sampled tokens on one
    set of fed noise, equal, with the exact launch counts; then the Whisper
    encoder at whisper-large-v3's widths on 1 s (100 mel frames), card vs
    CPU in f32, TF32 off."""
    import dataclasses

    from rwkvtts_torch.models import asr, rwkv7, s2s, whisper
    from rwkvtts_torch.models import tts_two_tower as tt
    from rwkvtts_torch.ops import sampling, wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.ops.packing import right_align_pack
    from rwkvtts_torch.ops.wkv7 import wkv7_scan

    out: dict = {"wkv7_fwd_errors": {}, "wkv7_step_errors": {}}
    g = torch.Generator(device=dev).manual_seed(61)
    tols = ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))
    for name, Bn, T, H, _ in ASR_WKV_SHAPES:
        for dtype, tol in tols:
            ins, _, _ = wkv_inputs(g, Bn, T, H, dtype)
            valid = torch.randint(T // 2, T + 1, (Bn,), generator=g, device=dev)
            right = (torch.arange(T, device=dev)[None] < valid[:, None]).int()
            _, mask, _ = right_align_pack([(torch.zeros(Bn, T, 1, device=dev), right, None)], T)
            check(bool((mask.sum(1) == valid).all()) and bool((mask[:, -1] == 1).all()),
                  f"asr small: right_align_pack's mask at {name}")
            ins[3] = ins[3] * mask[:, :, None, None].to(dtype)
            y_k, s_k = wkv7_cuda.wkv7_fwd(*ins, None, None)
            y_p, s_p = wkv7_scan(*(x.float() for x in ins), None, None)
            ey, es = rel(y_k, y_p), rel(s_k, s_p)
            out["wkv7_fwd_errors"][f"{name} {str(dtype)[6:]}"] = {
                "y_rel": ey, "state_rel": es, "max_abs_err": max_abs(y_k, y_p)}
            print(f"asr small: kernel 2 {str(dtype)[6:]} {name} ({Bn}, {T}, {H}), left-padded "
                  f"mask: y rel {ey:.3e}, state rel {es:.3e} (limit {tol:g})")
            check(ey <= tol and es <= tol, f"asr small: kernel 2 disagrees at {name}")
    for name, Bn, H in ASR_STEP_SHAPES:
        for vdt, tol in tols:
            s0 = 0.1 * torch.randn(Bn, H, 64, 64, generator=g, device=dev)
            s_k, s_p, ey = s0, s0, 0.0
            for _ in range(4):
                vecs = step_inputs(g, Bn, H, vdt)
                y_k, s_k = sp.wkv7_step_packed(s_k, *vecs, inplace=False)
                y_p, s_p = sp.wkv7_step_plain(s_p, *vecs, inplace=False)
                ey = max(ey, rel(y_k, y_p))
            es = rel(s_k, s_p)
            out["wkv7_step_errors"][f"{name} {str(vdt)[6:]}"] = {
                "y_rel": ey, "state_rel": es, "max_abs_err": max_abs(y_k, y_p)}
            print(f"asr small: kernel 7 {name} ({Bn}, {H}), f32 carry, {str(vdt)[6:]} vectors, "
                  f"4 chained steps on fresh buffers: y rel {ey:.3e}, state rel {es:.3e} "
                  f"(limit {tol:g})")
            check(ey <= tol and es <= 1e-4, f"asr small: kernel 7 disagrees at {name}")
    out["wkv7_fwd_times"] = wkv7_fwd_times("asr small: kernel 2", shapes=ASR_WKV_SHAPES)
    out["wkv7_step_times"] = wkv7_step_times(ASR_STEP_SHAPES)

    C, L, Bn, n_new = 128, 2, 4, 8
    tiny = dict(head_size=64, dtype=torch.float32)

    def ready(params, *towers):
        """Nonzero lora-in, output and FFN value matrices; heads x 10."""
        gr = torch.Generator().manual_seed(62)
        for tower in towers:
            p = params[tower] if tower else params
            randomize(p, gr)
            for head in ("head", "audio_head"):
                if head in p:
                    p[head] = 10.0 * p[head]
        return params

    def card_vs_cpu(what, fn, params, inputs, want_launches, width, modes, **kw):
        """fn(params, *inputs, **kw) on the card and on the CPU: greedy
        (temperature 0) and sampled (temperature 1 on one set of noise
        (n_new, Bn, width)) as `modes` lists."""
        noise = sampling.gumbel((n_new, Bn, width), torch.Generator().manual_seed(63))
        for mode in modes:
            res = {}
            for where in ("cpu", dev):
                on = lambda t: t.to(where)
                p = rwkv7.tree_map(on, params)
                args = [rwkv7.tree_map(on, x) for x in inputs]
                draw = (dict(temperature=0.0) if mode == "greedy"
                        else dict(temperature=1.0, noise=on(noise)))
                reset_xy_launches()
                toks, lengths = fn(p, *args, max_new_tokens=n_new, **draw, **kw)
                res[str(where)] = (toks.cpu(), lengths.cpu(), xy_launches())
            (t_c, l_c, _), (t_g, l_g, launches) = res["cpu"], res[str(dev)]
            same = torch.equal(t_c, t_g) and torch.equal(l_c, l_g)
            print(f"asr small: {what} {mode}, B={Bn}, {n_new} steps: card = CPU {same}; card "
                  f"launches {launches} (want {want_launches})")
            check(same, f"asr small: {what} {mode} on the card disagrees with the CPU")
            check(launches == want_launches, f"asr small: {what} launches {launches}")

    gi = torch.Generator().manual_seed(64)
    text = (torch.randint(1, 1000, (Bn, 6), generator=gi), torch.ones(Bn, 6, dtype=torch.int32))
    text[1][0, :2] = 0
    hints = (torch.randint(1, 1000, (Bn, 2), generator=gi), torch.ones(Bn, 2, dtype=torch.int32))
    small_whisper = whisper.WhisperEncoderConfig(n_mels=16, d_model=64, layers=1, heads=2,
                                                 ffn_dim=128)
    for variant in ("whisper", "discrete"):
        cfg = asr.default_config(C, L, adapter_layers=1, audio_vocab=64, variant=variant, **tiny)
        batch = {"text_ids": text[0], "text_mask": text[1], "hints_ids": hints[0],
                 "hints_mask": hints[1]}
        if variant == "whisper":
            cfg = dataclasses.replace(cfg, whisper=small_whisper)
            batch["mel"] = torch.randn(Bn, 40, 16, generator=gi)
            batch["mel_mask"] = torch.ones(Bn, 40, dtype=torch.int32)
            batch["mel_mask"][2, 30:] = 0
        else:
            batch["audio_ids"] = torch.randint(0, 64, (Bn, 12), generator=gi)
            batch["audio_mask"] = torch.ones(Bn, 12, dtype=torch.int32)
            batch["audio_mask"][2, :3] = 0
        params = ready(asr.init_params(torch.Generator().manual_seed(65), cfg), "adapter", "llm")
        card_vs_cpu(f"asr {variant}", lambda p, b, **kw: asr.transcribe(p, cfg, b, **kw), params,
                    [batch], {"wkv7_fwd": 1 + L, "decode_b64_step": 0, "wkv7_step": L * n_new}, 8,
                    ("greedy", "sampled"), top_k=8, top_p=0.9)

    cfg = s2s.default_config(C, L, vocab_size=1000, text_vocab=700, audio_vocab=300, **tiny)
    params = ready(s2s.init_params(torch.Generator().manual_seed(66), cfg), "")
    ids = torch.randint(0, 1000, (Bn, 10), generator=gi)
    for is_text, width, kw in ((True, 700, dict(top_k=0, top_p=1.0)),
                               (False, 50, dict(top_k=50, top_p=0.95))):
        card_vs_cpu(f"s2s {'text' if is_text else 'audio'} head",
                    lambda p, x, **k: s2s.generate(p, cfg, x, **k), params, [ids],
                    {"wkv7_fwd": L, "decode_b64_step": 0, "wkv7_step": L * n_new}, width,
                    ("greedy", "sampled"), is_text=is_text, eos_id=3, **kw)
    cfg = tt.default_config(C, 1, C, L, **tiny)
    params = ready(tt.init_params(torch.Generator().manual_seed(67), cfg), "text_lm", "audio_lm")
    tmask = torch.ones(Bn, 10, dtype=torch.int32)
    tmask[1, 7:] = 0  # a short prompt, right-padded as collate_two_tower pads
    card_vs_cpu("two-tower", lambda p, x, m, **k: tt.generate(p, cfg, x, m, **k), params,
                [ids, tmask], {"wkv7_fwd": 1 + L, "decode_b64_step": 0, "wkv7_step": L * n_new}, 50,
                ("sampled",))

    wcfg = whisper.WhisperEncoderConfig(**WHISPER_LARGE_V3)
    t0 = time.perf_counter()
    wp = whisper.init_params(torch.Generator(device=dev).manual_seed(68), wcfg)
    mel = torch.randn(1, 100, wcfg.n_mels, generator=torch.Generator().manual_seed(69))
    enc_g = whisper.apply(wp, wcfg, mel.to(dev)).cpu()
    enc_c = whisper.apply(rwkv7.tree_map(lambda t: t.cpu(), wp), wcfg, mel)
    e = rel(enc_g, enc_c)
    out["whisper_large_v3_1s"] = {"rel": e, "max_abs_err": max_abs(enc_g, enc_c),
                                  "shape": list(enc_g.shape)}
    print(f"asr small: Whisper encoder at whisper-large-v3's widths, 1 s (100 mel frames): out "
          f"{tuple(enc_g.shape)}, card vs CPU f32 rel {e:.3e} (limit 1e-4); "
          f"{time.perf_counter() - t0:.1f} s with the init and the CPU run")
    check(enc_g.shape == (1, 50, wcfg.d_model) and e <= 1e-4,
          "asr small: the Whisper encoder on the card disagrees with the CPU")
    return out


def _bf16_matrices(tree):
    """The JAX bench's cast: every leaf of 2 or more dimensions to bf16."""
    from rwkvtts_torch.models import rwkv7

    return rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.ndim >= 2 else t, tree)


def _timed(fn):
    """(result, wall seconds) of fn() up to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_asr_main(dev, card: str) -> dict:
    """The paths asr-0.4B-whisper-large-v3, s2s-0.4B-b32 and
    two-tower-0.4B-b16 (benchmarks/bench_families_scale.py's definitions,
    random weights from seed 0, matrices bf16): one warm-up call and two
    timed calls each. ASR: x realtime and RTF over the 240 audio seconds,
    the encoder, adapter, LLM prefill and decode ms (from calls of the
    stages alone), peak memory; S2S and two-tower: tok/s. Exact launch
    counts of kernels 2 and 7 on every timed call."""
    import dataclasses

    from rwkvtts_torch.models import asr, rwkv7, s2s, whisper
    from rwkvtts_torch.models import tts_two_tower as tt

    t_phase = time.perf_counter()
    out: dict = {}
    L, A = ASR_L, ASR_ADAPTER_L

    # asr-0.4B-whisper-large-v3
    cfg = dataclasses.replace(asr.default_config(ASR_C, ASR_L, adapter_layers=A),
                              whisper=whisper.WhisperEncoderConfig(**WHISPER_LARGE_V3))
    t0 = time.perf_counter()
    params = _bf16_matrices(asr.init_params(torch.Generator(device=dev).manual_seed(0), cfg))
    n_params = {k: sum(t.numel() for t in _leaves(v)) for k, v in params.items()}
    T_mel = int(ASR_SECONDS * 100)
    batch = {"mel": torch.randn(ASR_B, T_mel, cfg.whisper.n_mels,
                                generator=torch.Generator().manual_seed(0)).to(dev),
             "mel_mask": torch.ones(ASR_B, T_mel, dtype=torch.int32, device=dev),
             "text_ids": torch.ones(ASR_B, ASR_INSTR, dtype=torch.long, device=dev),
             "text_mask": torch.ones(ASR_B, ASR_INSTR, dtype=torch.int32, device=dev),
             "hints_ids": torch.ones(ASR_B, ASR_HINTS, dtype=torch.long, device=dev),
             "hints_mask": torch.ones(ASR_B, ASR_HINTS, dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    print(f"asr main: ASR LLM {ASR_C} x {L}, adapter {ASR_C} x {A}, whisper-large-v3 encoder "
          f"({n_params}) random, matrices bf16, built in {time.perf_counter() - t0:.1f} s")
    run = lambda: asr.transcribe(params, cfg, batch, max_new_tokens=ASR_NEW)
    run()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    walls, launches = [], []
    for _ in range(2):
        reset_xy_launches()
        (toks, lengths), s = _timed(run)
        walls.append(s)
        launches.append(xy_launches())
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        _, enc_s = _timed(lambda: whisper.apply(params["whisper"], cfg.whisper, batch["mel"],
                                                batch["mel_mask"]))
        _, aud_s = _timed(lambda: asr.audio_embeds(params, cfg, batch))
        def prefill():  # the audio tower, the pack and the LLM's prefill
            packed, mask, _ = asr._prompt(params, cfg, batch)
            return rwkv7.forward(params["llm"], cfg.llm, inputs_embeds=packed,
                                 attention_mask=mask, return_state=True)

        _, pre_s = _timed(prefill)
    wall = sum(walls) / len(walls)
    audio_s = ASR_B * ASR_SECONDS
    want = {"wkv7_fwd": A + L, "decode_b64_step": 0, "wkv7_step": L * ASR_NEW}
    r = {"B": ASR_B, "audio_s": audio_s, "walls_s": walls, "x_realtime": audio_s / wall,
         "rtf": wall / audio_s, "encoder_ms": 1e3 * enc_s, "adapter_ms": 1e3 * (aud_s - enc_s),
         "llm_prefill_ms": 1e3 * (pre_s - aud_s),
         "decode_ms": 1e3 * (wall - pre_s), "decode_ms_a_step": 1e3 * (wall - pre_s) / ASR_NEW,
         "launches": launches[-1], "peak_gib": peak / 2**30,
         "peak_over_start_gib": (peak - start_bytes) / 2**30}
    out["asr-0.4B-whisper-large-v3"] = r
    print(f"asr main: asr-0.4B-whisper-large-v3: B={ASR_B} x {ASR_SECONDS:.0f} s, "
          f"{ASR_INSTR} + {T_mel // 2} + {ASR_HINTS} prompt positions, {ASR_NEW} greedy tokens: "
          f"{', '.join(f'{w:.4f}' for w in walls)} s a call, {r['x_realtime']:.1f} x realtime, "
          f"RTF {r['rtf']:.5f} on {card}; stages alone: encoder {r['encoder_ms']:.2f} ms, "
          f"adapter {r['adapter_ms']:.2f} ms, LLM prefill {r['llm_prefill_ms']:.2f} ms, decode "
          f"(the call's rest) {r['decode_ms']:.2f} ms ({r['decode_ms_a_step']:.2f} ms a step); "
          f"launches {launches} (want {want} each); peak memory {peak / 2**30:.2f} GiB, "
          f"{(peak - start_bytes) / 2**30:.2f} over what the run started with")
    check(all(x == want for x in launches), f"asr main: launches {launches}, want {want}")
    check(toks.shape == (ASR_B, ASR_NEW) and bool(((toks >= 0) & (toks < 65536)).all())
          and bool(((lengths >= 0) & (lengths <= ASR_NEW)).all()),
          f"asr main: tokens {tuple(toks.shape)}, lengths {lengths.tolist()}")
    del params, batch
    torch.cuda.empty_cache()

    # s2s-0.4B-b32 and two-tower-0.4B-b16
    for path, Bn in (("s2s-0.4B-b32", S2S_B), ("two-tower-0.4B-b16", TT_B)):
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(0)
        if path.startswith("s2s"):
            cfg = s2s.default_config(ASR_C, ASR_L)
            params, towers = _bf16_matrices(s2s.init_params(g, cfg)), 1
            vocab = cfg.audio_vocab_size
            gen = lambda n, seed: s2s.generate(
                params, cfg, ids, is_text=False, max_new_tokens=n, top_k=50, top_p=0.95,
                eos_id=-1, generator=torch.Generator(device=dev).manual_seed(seed))
        else:
            cfg = tt.default_config(ASR_C, ASR_L, ASR_C, ASR_L)
            params, towers = _bf16_matrices(tt.init_params(g, cfg)), 2
            vocab = tt.AUDIO_VOCAB
            gen = lambda n, seed: tt.generate(
                params, cfg, ids, mask, max_new_tokens=n,
                generator=torch.Generator(device=dev).manual_seed(seed))
        ids = torch.randint(100, 60000, (Bn, S2S_PROMPT),
                            generator=torch.Generator().manual_seed(1)).to(dev)
        mask = torch.ones(Bn, S2S_PROMPT, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        print(f"asr main: {path}: {towers} x {ASR_C} x {ASR_L} random, matrices bf16, built in "
              f"{time.perf_counter() - t0:.1f} s")
        gen(ASR_WARM_NEW, 2)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        walls, launches = [], []
        for i in range(2):
            reset_xy_launches()
            (toks, lengths), s = _timed(lambda: gen(S2S_NEW, 3 + i))
            walls.append(s)
            launches.append(xy_launches())
        peak = torch.cuda.max_memory_allocated()
        wall = sum(walls) / len(walls)
        want = {"wkv7_fwd": towers * L, "decode_b64_step": 0, "wkv7_step": L * S2S_NEW}
        r = {"B": Bn, "walls_s": walls, "tok_per_s": Bn * S2S_NEW / wall,
             "ms_a_step": 1e3 * wall / S2S_NEW, "launches": launches[-1],
             "peak_gib": peak / 2**30, "peak_over_start_gib": (peak - start_bytes) / 2**30}
        out[path] = r
        print(f"asr main: {path}: B={Bn}, {S2S_PROMPT} + {S2S_NEW} tokens at top-k 50 / top-p "
              f"0.95: {', '.join(f'{w:.4f}' for w in walls)} s a call, {r['tok_per_s']:.1f} "
              f"tok/s, {r['ms_a_step']:.2f} ms a step (prefill and sampling in) on {card}; "
              f"launches {launches} (want {want} each); peak memory {peak / 2**30:.2f} GiB, "
              f"{(peak - start_bytes) / 2**30:.2f} over what the run started with")
        check(all(x == want for x in launches), f"asr main: {path} launches {launches}")
        check(toks.shape == (Bn, S2S_NEW) and bool(((toks >= 0) & (toks < vocab)).all()),
              f"asr main: {path} tokens {tuple(toks.shape)} out of [0, {vocab})")
        del params
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"asr main: the phase took {out['phase_s']:.1f} s")
    return out


def asr_of_tree(what: str = "asr") -> dict:
    """Phases 26-27 alone (the ASR, S2S and two-tower slice small on card vs
    CPU with kernels 2 and 7 at its shapes, then its paths at full width)
    with whichever rwkvtts_torch is imported, TF32 off; prints their
    numbers as one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"small": phase_asr_small(dev), "main": phase_asr_main(dev, card)}
    print(f"{what}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# 28-29. Every training task of the train CLI
# ---------------------------------------------------------------------------

# the train tasks' shapes of kernels 4-5 (name, B, T, H, mask, also in f32, the
# plain version timed): the Cosy LM at 2048 wide, the ASR adapter over 30 s of
# encoder frames (a right-padded mask, a ragged last chunk), the ASR LLM's
# packed [instruction][audio][hints][labels] and the two-tower audio tower's
# packed [text][audio] (left-padded masks from right_align_pack), then the
# other shapes phase 29 launches: spark_global's 64 rows padded to 128, the
# two-tower text tower's right-padded 128 text positions and Spark 1.4B's two
# full rows; the f32 checks and the plain version's times (seconds each)
# where they say most
TASK_B, TASK_T, TT_TEXT, ASR_LABELS = 8, 2048, 128, 64
TASK_FUSED_SHAPES = (("cosy", TASK_B, TASK_T, 32, None, False, True),
                     ("asr adapter", TASK_B, ASR_FRAMES, 16, "right", True, False),
                     ("asr llm", TASK_B, ASR_INSTR + ASR_FRAMES + ASR_HINTS + ASR_LABELS, 16,
                      "left", True, False),
                     ("two-tower", TASK_B, TT_TEXT + TASK_T, 16, "left", False, False),
                     ("spark_global", 64, 128, 16, "right", False, False),
                     ("two-tower text", TASK_B, TT_TEXT, 16, "right", False, False),
                     ("spark 1.4B", 2, TASK_T, 32, None, False, False))
# a warm-up step and 3 timed ones; the CLI reads step k's metrics after
# issuing step k + 1, so that read (and its log's time stamp) waits for the end
# of step k + 1: the window opens at the end of the step after the warm-up,
# and the runs take one step more than TASK_WARM + TASK_TIMED
TASK_WARM, TASK_TIMED = 1, 3
# the main runs' widths: the 0.4B families at 1024 x 24, Cosy's 1.5B pairing
# LM at COSY_C, Spark at 1.4B (benchmarks/bench_flagship_scale.py:215-220)
TASK_C, TASK_L, SPARK_BIG_C = 1024, 24, 2048
SFM_TOKENS = 250
TASKS = ("spark_properties", "spark_global", "cosy", "xy", "asr", "s2s", "tts_two_tower",
         "sfm_flow", "spark")


def fused_bounds(seq) -> tuple:
    """Kernels 4 and 5's bounds at seq's shape (B, T, H, 64), as (ms, by):
    the saving forward reads 5 sequences and writes y, the entry states and
    the final state; the primal forward the same without the entry states;
    both 9 FLOP an element a step; the backward reads 5 sequences, dy and
    the entry states and writes 5 gradients, 22 FLOP an element a step;
    TF32 on the tensor cores, as both kernels compute."""
    elems = math.prod(seq[0].shape)
    return (bound_ms(train_shape_bytes(seq, 6), 9 * 64 * elems, TF32_TC_FLOPS),
            bound_ms(train_shape_bytes(seq, 6, entry_states=False), 9 * 64 * elems,
                     TF32_TC_FLOPS),
            bound_ms(train_shape_bytes(seq, 11), 22 * 64 * elems, TF32_TC_FLOPS))


def task_fused_check(dev, g, name: str, Bn: int, T: int, H: int, mask_kind, f32: bool,
                     time_plain: bool) -> dict:
    """Kernels 4-5 against wkv7_fused_plain at one train-task shape: bf16
    (and, with `f32`, f32) outputs and every gradient, v zero at the mask's
    pads as the model feeds it; two calls bit-identical; the saving /
    primal forward and the backward in device ms (fused_times, queued_ms:
    torch.profiler keeps no launch late in the whole run); with
    `time_plain`, the plain version's forward and backward ms (CUDA events,
    f32); the bounds (fused_bounds)."""
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops.packing import right_align_pack
    from rwkvtts_torch.ops.wkv7 import wkv7_fused_plain

    valid = torch.randint(T // 2, T + 1, (Bn,), generator=g, device=dev)
    mask = (torch.arange(T, device=dev)[None] < valid[:, None]).int()
    if mask_kind == "left":
        _, mask, _ = right_align_pack([(torch.zeros(Bn, T, 1, device=dev), mask, None)], T)
    out = {"B": Bn, "T": T, "H": H, "mask": mask_kind, "rel": {}}
    for dtype, tol in ((torch.bfloat16, 2e-2),) + (((torch.float32, 1e-4),) if f32 else ()):
        seq, prm, _, _ = fused_inputs(g, Bn, T, H, dtype)
        if mask_kind:
            seq[3] = seq[3] * mask[:, :, None, None].to(dtype)
        o_err, g_err, rels = grad_check(wkv7_cuda.wkv7_fused, wkv7_fused_plain, seq + prm, [], g,
                                        tol, f"train tasks small: kernels 4-5 {str(dtype)[6:]} "
                                        f"{name} ({Bn}, {T}, {H}), mask {mask_kind}")
        out["rel"][str(dtype)[6:]] = {"worst": max(rels.values()), "out_max_abs": o_err,
                                      "grad_max_abs": g_err}
    runs = []
    dy = torch.randn(seq[0].shape, generator=g, device=dev).to(seq[0].dtype)
    ds = torch.randn(Bn, H, 64, 64, generator=g, device=dev)
    for _ in range(2):
        ins = [x.detach().clone().requires_grad_() for x in seq + prm]
        y, st = wkv7_cuda.wkv7_fused(*ins)
        runs.append([y, st, *torch.autograd.grad((y, st), ins, (dy, ds))])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, f"train tasks small: kernels 4-5 at {name} are not deterministic")
    seq = [x.to(torch.bfloat16) for x in seq]
    times = fused_times(seq, prm, device=True)
    p_fwd, p_bwd = (time_fwd_bwd(wkv7_fused_plain, [x.float() for x in seq + prm], [], 1)
                    if time_plain else (None, None))
    (fb, fby), (pb, pby), (bb, bby) = fused_bounds(seq)
    out.update({"bit_identical": same, **times, "plain_fwd_ms": p_fwd, "plain_bwd_ms": p_bwd,
                "fwd_bound_ms": fb, "fwd_bound_by": fby, "primal_bound_ms": pb,
                "primal_bound_by": pby, "bwd_bound_ms": bb, "bwd_bound_by": bby})
    shown = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in times.items())
    print(f"train tasks small: kernels 4-5 bf16 {name} ({Bn}, {T}, {H}): two calls bit-identical "
          f"{same}; ms {shown}; plain "
          f"{f'{p_fwd:.4f} / {p_bwd:.4f} ms' if time_plain else 'not timed here'}; bounds "
          f"{fb:.4f} ({fby}) saving, {pb:.4f} ({pby}) primal / {bb:.4f} ({bby})")
    return out


def text_of_tokens(tok, n: int, rng) -> str:
    """A text of random words that the world tokenizer encodes to exactly n
    tokens: the most words that stay under n (a bisection over the word
    count), then " x" (one token) to fill."""
    import numpy as np

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.integers(2, 9))) for _ in range(n)]
    count = lambda k: len(tok.encode(" ".join(words[:k])))
    lo, hi = 0, n  # count(lo) <= n - 4 < count(hi), or hi = n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if count(mid) <= n - 4 else (lo, mid)
    text = " ".join(words[:lo])
    text += " x" * (n - len(tok.encode(text)))
    check(len(tok.encode(text)) == n, f"text_of_tokens: {len(tok.encode(text))} != {n}")
    return text


def task_rows(task: str, seed: int, n: int, T: int):
    """n jsonl rows of `task` whose collated sample fills about T positions
    (exactly T where the layout allows): random words, token ids in their
    vocabularies, the properties of the SPCT prefix; sfm_flow rows carry T
    speech tokens, 2 T precomputed mel frames and an x-vector."""
    import numpy as np

    from rwkvtts_torch.infer.xy_pipeline import xy_text_tokenizer
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    tok, xy_tok = get_world_tokenizer(), xy_text_tokenizer()
    rng = np.random.default_rng(seed)
    ages = ["child", "teenager", "youth-adult", "middle-aged", "elderly"]
    props = lambda i: {"age": ages[i % 5], "gender": ("female", "male")[i % 2],
                       "emotion": ("HAPPY", "NEUTRAL", "SAD", "ANGRY")[i % 4],
                       "pitch": float(rng.uniform(100, 260)), "speed": float(rng.uniform(2, 6))}
    ints = lambda hi, k: rng.integers(0, hi, k).tolist()
    rows = []
    for i in range(n):
        n_text = int(rng.integers(8, max(9, min(40, T // 8))))
        if task.startswith("spark"):
            # plain: 3 tags, the text, 32 globals, the semantic tokens and EOS;
            # properties: the 6 SPCT tokens before it too
            n_sem = T - 36 - n_text - (6 if task == "spark_properties" else 0)
            rows.append({"text": text_of_tokens(tok, n_text, rng), "global_tokens": ints(4096, 32),
                         "semantic_tokens": ints(8192, max(n_sem, 1)), **props(i)})
        elif task == "cosy":
            # [SOS][prompt text + text][TASK][prompt speech + speech] = T
            n_prompt = int(rng.integers(60, 120))
            rows.append({"text": text_of_tokens(tok, n_text, rng),
                         "prompt_text": text_of_tokens(tok, 6, rng),
                         "llm_prompt_speech_token": ints(6561, n_prompt),
                         "tts_speech_tokens": ints(6561, T - 2 - n_text - 6 - n_prompt)})
        elif task == "xy":
            text = text_of_tokens(tok, n_text, rng)
            T1 = len(xy_tok.encode(f"[S0]{text}[CTL0]"))
            rows.append({"text": text, "audio_tokens": rng.integers(0, 1023, (8, T - T1 - 7)).tolist()})
        elif task == "s2s":
            rows.append({"text": text_of_tokens(tok, T, rng), "audio_tokens": ints(8192, T)})
        elif task == "tts_two_tower":
            rows.append({"text": text_of_tokens(tok, TT_TEXT if i == 0 else n_text, rng),
                         "global_tokens": ints(4096, 32), "semantic_tokens": ints(8192, T - 33)})
        elif task == "sfm_flow":
            rows.append({"speech_token": ints(6561, T),
                         "speech_feat": np.round(rng.standard_normal((2 * T, 80)), 3).tolist(),
                         "embedding": rng.standard_normal(192).round(4).tolist()})
        else:
            raise ValueError(task)
    return rows


def task_configs(task: str, C: int, L: int, dtype, fuse: bool = True):
    """(config, frozen prefixes) of a task at LM width C x L; ASR with a
    1-layer adapter and a 1-layer Whisper of width 64 at small widths, the
    large-v3 encoder and a 6-layer adapter at full width; the SFM flow at
    FlowConfig(sfm=True)."""
    import dataclasses

    from rwkvtts_torch.codecs import flow
    from rwkvtts_torch.models import asr, cosy, s2s, spark, whisper, xy
    from rwkvtts_torch.models import tts_two_tower as tt

    kw = dict(hidden_size=C, num_layers=L, dtype=dtype, wkv_fuse_prep=fuse)
    if task.startswith("spark"):
        return spark.default_config(**kw)
    if task == "cosy":
        return cosy.default_config(**kw)
    if task == "xy":
        return xy.default_config(**kw)
    if task == "s2s":
        return s2s.default_config(**kw)
    if task == "tts_two_tower":
        return tt.default_config(C, L, C, L, dtype=dtype, wkv_fuse_prep=fuse)
    if task == "sfm_flow":
        return flow.FlowConfig(sfm=True)
    big = C == ASR_C
    wcfg = whisper.WhisperEncoderConfig(**(WHISPER_LARGE_V3 if big else dict(
        n_mels=16, d_model=64, layers=1, heads=2, ffn_dim=128)))
    return dataclasses.replace(asr.default_config(adapter_layers=ASR_ADAPTER_L if big else 1, **kw),
                               whisper=wcfg)


def asr_train_batch(cfg, Bn: int, seconds: float, g: torch.Generator, dev) -> dict:
    """An ASR batch: Bn rows of `seconds` of random mel, ASR_INSTR
    instruction, ASR_HINTS hint and ASR_LABELS label tokens, every mask one."""
    T_mel = int(seconds * 100)
    ids = lambda n: torch.randint(1, 65536, (Bn, n), generator=g).to(dev)
    ones = lambda n: torch.ones(Bn, n, dtype=torch.int32, device=dev)
    return {"mel": torch.randn(Bn, T_mel, cfg.whisper.n_mels, generator=g).to(dev),
            "mel_mask": ones(T_mel), "text_ids": ids(ASR_INSTR), "text_mask": ones(ASR_INSTR),
            "hints_ids": ids(ASR_HINTS), "hints_mask": ones(ASR_HINTS),
            "labels": ids(ASR_LABELS), "labels_mask": ones(ASR_LABELS)}


def rwkv_stacks(task: str, cfg) -> list:
    """The RWKV stacks a task's step runs, by their layer counts."""
    if task == "sfm_flow":
        return []
    if task == "asr":
        return [cfg.adapter.num_layers, cfg.llm.num_layers]
    if task == "tts_two_tower":
        return [cfg.text.num_layers, cfg.audio.num_layers]
    return [cfg.backbone.num_layers]


def sfm_fixed_draws_loss():
    """The sfm_flow adapter with its draws made on the CPU from seed 71 and
    moved to the batch's device, so the card and the CPU take one step."""
    from rwkvtts_torch.codecs import flow

    def fixed(params, cfg, batch, generator):
        x1 = batch["feat"]
        g = torch.Generator().manual_seed(71)
        draws = {"x0": torch.randn(x1.shape, generator=g), "t_u": torch.rand(x1.shape[0], 1, 1,
                                                                             generator=g),
                 "keep": torch.rand(x1.shape[0], generator=g) > flow.TRAINING_CFG_RATE}
        total, _ = flow.sfm_loss(params, cfg, *(batch[k] for k in (
            "tokens", "token_mask", "feat", "feat_mask", "embedding")),
            **{k: v.to(x1.device) for k, v in draws.items()})
        return total, batch["feat_mask"].sum().to(torch.int32)

    return fixed


def phase_train_tasks_small(dev) -> dict:
    """Kernels 4-5 against their plain version at the train tasks' shapes
    (TASK_FUSED_SHAPES), then each of the nine tasks at LM 128 x 2 in f32
    (the SFM flow at FlowConfig(sfm=True); spark_global on the unfused pair):
    one train step on the card vs the same step on the CPU's plain path,
    loss within 1e-4 and grad norm within 1e-3, and the pair's launches, 2 L
    and L a step a stack."""
    import types

    from rwkvtts_torch.models import asr, rwkv7
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.parallel import train_step as ts
    from rwkvtts_torch.train import cli, trainer
    from rwkvtts_torch.train import optimizer as opt_lib

    g = torch.Generator(device=dev).manual_seed(70)
    out = {"kernels": {name: task_fused_check(dev, g, name, *shape)
                       for name, *shape in TASK_FUSED_SHAPES}, "steps": {}}
    args = types.SimpleNamespace(pad_to=None, packed=False, seed=0, drop_prompt_audio_rate=0.5)
    for task in TASKS:
        fuse = task != "spark_global"  # one task on the unfused pair, kernels 2-3
        cfg = task_configs(task, 128, 2, torch.float32, fuse)
        if task == "asr":
            params = asr.init_params(torch.Generator().manual_seed(3), cfg)
        else:
            params = cli.build_model(task, types.SimpleNamespace(
                hidden=128, layers=2, head_size=64, bf16=False, no_wkv_fuse_prep=False, seed=3),
                torch.device("cpu"))[1]
        gr = torch.Generator().manual_seed(72)
        for tree in [params, *params.values()]:
            if isinstance(tree, dict) and "blocks" in tree and "att" in tree["blocks"]:
                randomize(tree, gr)
        if task == "asr":
            batch = {k: v.cpu() for k, v in asr_train_batch(cfg, 3, 0.6, torch.Generator()
                                                            .manual_seed(73), "cpu").items()}
        else:
            rows = task_rows(task, 74, 3, 24 if task == "sfm_flow" else 160)
            args.pad_to = 24 if task == "sfm_flow" else None
            batch = cli.build_collate(task, args, cfg)(rows)
            batch = {k: v if k.startswith("_") else torch.as_tensor(v) for k, v in batch.items()}
        loss_fn = sfm_fixed_draws_loss() if task == "sfm_flow" else trainer.LOSS_FNS[task]
        res = {}
        for where in ("cpu", dev):
            p = rwkv7.tree_map(lambda t: t.to(where).clone(), params)
            opt = opt_lib.AdamW(p, warmup_steps=0, frozen=ts.frozen_prefixes(cfg))
            step = ts.make_train_step(cfg, opt, loss_fn)
            wkv7_cuda.reset_launches()
            _, m = step(ts.init_train_state(p, opt), {k: v if k.startswith("_") else v.to(where)
                                                      for k, v in batch.items()}, None)
            res[str(where)] = (m["loss"].item(), m["grad_norm"].item(), int(m["skipped"]),
                               dict(wkv7_cuda.launches))
        (lc, gc, _, _), (lg, gg, skipped, launches) = res["cpu"], res[str(dev)]
        el, eg = abs(lg - lc) / abs(lc), abs(gg - gc) / abs(gc)
        stacks = rwkv_stacks(task, cfg)
        want = (2 * sum(stacks), sum(stacks))
        pair = ("wkv7_fused_fwd", "wkv7_fused_bwd") if fuse else ("wkv7_fwd", "wkv7_bwd")
        got = tuple(launches[k] for k in pair)
        out["steps"][task] = {"loss": lg, "loss_cpu": lc, "loss_rel": el, "grad_norm_rel": eg,
                              "launches": dict(zip(pair, got))}
        print(f"train tasks small: {task} {'LM 128 x 2' if stacks else 'FlowConfig(sfm=True)'} "
              f"f32{'' if fuse else ', unfused'}: loss {lg:.6f} vs {lc:.6f} on the CPU (rel "
              f"{el:.2e}, limit 1e-4), grad norm {gg:.6f} vs {gc:.6f} (rel {eg:.2e}, limit "
              f"1e-3); {' / '.join(pair)} launches {got} (want {want})")
        check(el <= 1e-4 and eg <= 1e-3 and skipped == 0,
              f"train tasks small: {task}'s step disagrees with the CPU")
        check(got == want, f"train tasks small: {task} launches {got}, want {want}")
    return out


def _task_cli_args(task, dev, data, run_dir, C, L, Bn, pad_to, extra=()):
    return ["--task", task, "--data", data, "--run-dir", run_dir, "--device", str(dev),
            "--hidden", str(C), "--layers", str(L), "--batch-size", str(Bn),
            "--pad-to", str(pad_to), "--log-every", "1", "--save-steps", "0", *extra]


def phase_train_tasks_main(dev, card: str) -> dict:
    """Each task through train.cli.main (ASR through Trainer) at its
    family's width, random weights from seed 0, bf16 over f32 masters, the
    fused pair: TASK_WARM warm-up and TASK_TIMED timed steps (the CLI runs
    one more, TASK_WARM's comment). Gates: finite
    losses, no skipped step, the first loss within 0.5 of ln(vocabulary)
    where one head is trained, exactly 2 L kernel-4 and L kernel-5 launches a
    step a stack, the Whisper leaves bit-identical. Prints ms a step,
    positions/s and peak memory; then one mu_bf16 step at 1024 x 24. The
    end-of-epoch checkpoint of each run is not written (phase 10 writes
    one): its bytes are not the step's."""
    from rwkvtts_torch.models import asr
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.train import cli, trainer
    from rwkvtts_torch.train import optimizer as opt_lib

    n_steps = TASK_WARM + 1 + TASK_TIMED
    vocab = {"spark_properties": 8193, "spark_global": 8193, "spark": 8193, "cosy": 6562,
             "asr": 65536, "s2s": 8192, "tts_two_tower": 12289}  # s2s: its first batch is audio
    # (task, hidden, layers, batch rows, pad_to, row length, extra flags, positions a step)
    C, L = TASK_C, TASK_L
    plan = [("spark_properties", C, L, TASK_B // 2, TASK_T, TASK_T, (), TASK_B * TASK_T),
            ("spark_global", C, L, 64, 128, 40, (), 64 * 128),
            ("cosy", COSY_C, L, TASK_B, TASK_T, TASK_T, ("--drop-prompt-audio-rate", "0.5"),
             TASK_B * TASK_T),
            ("xy", C, L, TASK_B, TASK_T, TASK_T, (), TASK_B * TASK_T),
            ("asr", ASR_C, ASR_L, ASR_B, None, None, (), None),
            ("s2s", C, L, TASK_B, TASK_T, TASK_T, (), TASK_B * TASK_T),
            ("tts_two_tower", C, L, TASK_B, TASK_T, TASK_T, (), TASK_B * (TT_TEXT + TASK_T)),
            ("sfm_flow", None, None, TASK_B, SFM_TOKENS, SFM_TOKENS, (), TASK_B * 2 * SFM_TOKENS),
            ("spark", SPARK_BIG_C, L, 2, TASK_T, TASK_T, ("--low-memory-opt", "adafactor"),
             2 * TASK_T)]
    saves = []
    real_save = trainer.Trainer.save
    trainer.Trainer.save = lambda self, epoch, batch: saves.append(self.state.step)
    out: dict = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for task, C, L, Bn, pad_to, T, extra, positions in plan:
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                wkv7_cuda.reset_launches()
                t_task = time.perf_counter()
                if task == "asr":
                    cfg = task_configs("asr", C, L, torch.bfloat16)
                    params = asr.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
                    whisper0 = {p: t.clone() for p, t in opt_lib.flatten(params["whisper"]).items()}
                    tcfg = trainer.TrainerConfig(run_dir=os.path.join(tmp, task), save_steps=0,
                                                 log_every=1)
                    tr = trainer.Trainer(cfg, params, trainer.LOSS_FNS["asr"], tcfg, dev)
                    batch = asr_train_batch(cfg, Bn, ASR_SECONDS, torch.Generator().manual_seed(0),
                                            dev)
                    positions = Bn * (ASR_INSTR + ASR_FRAMES + ASR_HINTS + ASR_LABELS)
                    losses, skipped = [], 0
                    for i in range(TASK_WARM + TASK_TIMED):
                        if i == TASK_WARM:
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                        tr.state, m = tr.step_fn(tr.state, batch, tr.generator)
                        losses.append(m["loss"])
                        skipped += m["skipped"]
                    torch.cuda.synchronize()
                    step_s = (time.perf_counter() - t0) / TASK_TIMED
                    losses, skipped = [x.item() for x in losses], int(skipped)
                    after = opt_lib.flatten(tr.state.params["whisper"])
                    frozen_same = all(torch.equal(after[p], t) for p, t in whisper0.items())
                    check(frozen_same, "train tasks main: asr: a Whisper leaf moved")
                    check(not any(p.startswith("whisper/") for p in tr.optimizer.labels),
                          "train tasks main: asr: the Whisper encoder is in the optimizer")
                    del whisper0, batch
                else:
                    data = os.path.join(tmp, f"{task}.jsonl")
                    with open(data, "w") as f:
                        for row in task_rows(task, 80, Bn * n_steps, T):
                            f.write(json.dumps(row) + "\n")
                    run_dir = os.path.join(tmp, task)
                    args = _task_cli_args(task, dev, data, run_dir, C or 64, L or 1, Bn, pad_to,
                                          extra)
                    tr = cli.main(args)
                    torch.cuda.synchronize()
                    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                        recs = [json.loads(line) for line in f]
                    check(len(recs) == n_steps, f"train tasks main: {task}: {len(recs)} steps")
                    losses = [r["loss"] for r in recs]
                    skipped = sum(int(r["skipped"]) for r in recs)
                    # log k (from 1) is stamped at the end of step k + 1, the last
                    # two at the end of the last step (TASK_WARM's comment)
                    t = [r["time"] for r in recs]
                    step_s = (t[n_steps - 2] - t[TASK_WARM - 1]) / TASK_TIMED
                    cfg = tr.model_cfg
                launches = dict(wkv7_cuda.launches)
                peak = torch.cuda.max_memory_allocated()
                stacks = rwkv_stacks(task, cfg)
                steps = len(losses)
                want = (2 * sum(stacks) * steps, sum(stacks) * steps)
                got = (launches["wkv7_fused_fwd"], launches["wkv7_fused_bwd"])
                n_params = sum(x.numel() for x in opt_lib.flatten(tr.state.params).values())
                r = {"hidden": C, "layers": L, "batch": Bn, "positions_a_step": positions,
                     "params": n_params, "losses": losses, "step_ms": 1e3 * step_s,
                     "positions_per_s": positions / step_s, "peak_gib": peak / 2**30,
                     "fused_launches_a_step": [x / steps for x in got],
                     "optimizer": tr.optimizer.low_memory or "adamw",
                     "task_s": time.perf_counter() - t_task}
                out[task] = r
                print(f"train tasks main: {task} {C} x {L} ({n_params / 1e9:.3f} B params, "
                      f"{r['optimizer']}), {Bn} rows, {positions} positions a step: losses "
                      f"{[round(x, 4) for x in losses]}; {r['step_ms']:.2f} ms a step over "
                      f"{TASK_TIMED} steps, {r['positions_per_s']:.1f} positions/s, peak memory "
                      f"{r['peak_gib']:.2f} GiB on {card}; kernels 4 / 5 {got} (want {want}); "
                      f"{r['task_s']:.1f} s in all")
                check(all(math.isfinite(x) for x in losses), f"{task}: non-finite loss {losses}")
                check(skipped == 0, f"train tasks main: {task}: a step was skipped")
                if task in vocab:
                    check(abs(losses[0] - math.log(vocab[task])) <= 0.5,
                          f"train tasks main: {task}: first loss {losses[0]:.4f} not within 0.5 "
                          f"of ln {vocab[task]}")
                check(got == want, f"train tasks main: {task} launches {got}, want {want}")
                if task == "spark":
                    check("v_row" in tr.state.opt_state, "spark 1.4B: not the adafactor state")
                del tr
            # one mu_bf16 step at 1024 x 24: an epoch of one batch
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            wkv7_cuda.reset_launches()
            data = os.path.join(tmp, "spark_mu.jsonl")
            with open(data, "w") as f:
                for row in task_rows("spark", 81, TASK_B, TASK_T):
                    f.write(json.dumps(row) + "\n")
            run_dir = os.path.join(tmp, "spark_mu")
            C, L = TASK_C, TASK_L
            tr = cli.main(_task_cli_args("spark", dev, data, run_dir, C, L, TASK_B, TASK_T,
                                         ("--low-memory-opt", "mu_bf16")))
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                rec = json.loads(f.readline())
            m_dtype = next(iter(tr.state.opt_state["mu"].values())).dtype
            got = (wkv7_cuda.launches["wkv7_fused_fwd"], wkv7_cuda.launches["wkv7_fused_bwd"])
            peak = torch.cuda.max_memory_allocated()
            out["spark_mu_bf16"] = {"loss": rec["loss"], "fused_launches": got,
                                    "mu_dtype": str(m_dtype), "peak_gib": peak / 2**30}
            print(f"train tasks main: spark {C} x {L} mu_bf16, one step: loss {rec['loss']:.4f}, "
                  f"first moment {m_dtype}, kernels 4 / 5 {got} (want {(2 * L, L)}), peak memory "
                  f"{peak / 2**30:.2f} GiB")
            check(m_dtype == torch.bfloat16 and got == (2 * L, L) and rec["skipped"] == 0
                  and abs(rec["loss"] - math.log(8193)) <= 0.5, "train tasks main: the mu_bf16 step")
            del tr
            torch.cuda.empty_cache()
    finally:
        trainer.Trainer.save = real_save
    print(f"train tasks main: end-of-epoch checkpoints not written at steps {saves}")
    return out


def train_tasks_of_tree(what: str = "train tasks") -> dict:
    """Phases 28-29 alone (kernels 4-5 at the train tasks' shapes, the nine
    tasks small on card vs CPU, then each at its family's width) with
    whichever rwkvtts_torch is imported, TF32 off; prints their numbers as
    one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"small": phase_train_tasks_small(dev), "main": phase_train_tasks_main(dev, card)}
    print(f"{what}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# 30-34. Long-form text, phoneme-marked training and the seed-tts eval
# ---------------------------------------------------------------------------

# phase 30: two paragraphs of 6-8 sentences through synthesize_long at the
# 1.5B pairing, chunks of at most LONG_MAX_N text tokens, each capped at
# LONG_CAP speech tokens; together they hold digits, a date, a time, a
# percentage, a phone number and a unit
LONG_ZH = ("今天是2024年3月15日，天气很好。我们上午9:30在公园门口见面。请带上2瓶水和3个苹果。"
           "公园离这里大约3.5km，走路要四十分钟。门票价格是¥25.5，学生可以打8折。"
           "去年参观的人数增长了35%，达到了1,200,000人。如果有问题，请拨打13812345678联系我。"
           "下午的气温大约是26℃，记得带好帽子。")
LONG_EN = ("On March 3, 2024 the meeting starts at 10:45 on floor 2. We expect 125 people to attend. "
           "Last year the company grew by 18% and hired 42 engineers. "
           "The new office is 2.5 km from the station. "
           "Please call 555 0199 if you need directions. "
           "Lunch will be served at 12:30 for everyone. "
           "The event ends at 5 in the afternoon, and the doors close at 6.")
LONG_MAX_N, LONG_CAP, LONG_SEED = 80, 400, 7
# phase 31: the pronunciation fine-tune through the train CLI (spark_properties,
# 1024 x 24, 4 rows = 8 sequences of at most 2048): rows leave room for the marks
MARK_PROB, MARK_ROOM = 0.5, 96
# phase 32: a 4-row zh/meta.lst, 6 s prompt clips, the transcription backend's steps
SEED_ROWS, SEED_NEW, SEED_ASR_NEW = 4, 200, 32
SEED_TEXTS = ("今天的天气非常好，我们一起去公园散步吧。", "人工智能正在改变世界，语音合成技术让机器开口说话。",
              "请在下午三点之前把报告发给我。", "这家餐厅的菜很好吃，价格也不贵。")
# phase 33: the JAX ranking test's sizes (tests/test_ranking_demo.py:10-18)
RANK_SENTENCES, RANK_STEPS = 8, 300
# phase 34: greedy Spark generation at 1024 x 24, B = 8, 128 + 128 tokens
GREEDY_C, GREEDY_L, GREEDY_B, GREEDY_PROMPT, GREEDY_NEW = 1024, 24, 8, 128, 128


def all_launches() -> dict:
    """The seven kernels' launch counts since their last reset."""
    from rwkvtts_torch.ops import decode_mega as dm
    from rwkvtts_torch.ops import decode_mega_b64 as dmb
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp

    return {**wkv7_cuda.launches, "decode_b64_step": dmb.launches, "decode_b1_step": dm.launches,
            "wkv7_step": sp.launches}


def reset_all_launches() -> None:
    from rwkvtts_torch.ops import decode_mega as dm

    reset_xy_launches()
    dm.reset_launches()


def long_pipeline(dev):
    """The 1.5B pairing of phase 20 (random weights, seeds 0-4, matrices
    bf16) with the port's world tokenizer: a CosyPipeline on its default
    route, the B=1 kernel."""
    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import flow, hift
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import cosy
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    cfg = cosy.default_config(hidden_size=COSY_C, num_layers=COSY_L)
    gen_dev = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    params = _bf16_matrices(cosy.init_params(gen_dev(0), cfg))
    fcfg, hcfg = flow.FlowConfig(), hift.HiFTConfig()
    s3cfg, ccfg = s3.S3TokenizerConfig(), cp.CampplusConfig()
    return CosyPipeline(cfg, params, get_world_tokenizer(), fcfg, flow.init_params(gen_dev(1), fcfg),
                        hcfg, hift.init_params(gen_dev(2), hcfg), s3_cfg=s3cfg,
                        s3_params=s3.init_params(gen_dev(3), s3cfg), campplus_cfg=ccfg,
                        campplus_params=cp.init_params(gen_dev(4), ccfg), device=dev)


def decoded_steps(pipe, chunk: str, prompt_text: str, n_tokens: int, chunk_len: int = 64) -> int:
    """The decode steps cosy_generate runs for a chunk that gave n_tokens:
    all max_len without an EOS, else up to the end of the 64-step chunk in
    which it came (its early exit)."""
    from rwkvtts_torch.data import cosy_collator

    ids = pipe.tok.encode(prompt_text) + pipe.tok.encode(chunk)
    max_len = min(int(cosy_collator.content_length(ids) * 20), LONG_CAP)
    if n_tokens >= max_len:
        return max_len
    return min(max_len, chunk_len * (n_tokens // chunk_len + 1))


def phase_cosy_long(dev, card: str) -> dict:
    """CosyPipeline.synthesize_long at the 1.5B pairing (phase 20's
    configuration, the world tokenizer, the B=1 kernel route) on a zh and
    an en paragraph from a 6 s prompt: the normalized text, the chunks (=
    the port's text frontend on the host), each chunk's tokens, the wall
    split into frontend, LM, flow and HiFT, the RTF; the result = the
    concatenation of synthesize(chunk_i, seed + i) on the same frontend
    outputs (tokens equal, wav within 1e-5 of its largest sample), kernel
    2 run 24 times a chunk and kernel 6 121 times a decoded token."""
    import numpy as np

    from rwkvtts_torch.data import text_frontend
    from rwkvtts_torch.ops import decode_mega as dm

    t0 = time.perf_counter()
    pipe = long_pipeline(dev)
    clip = prompt_clip(ZS_PROMPT_S, seed=5)
    prompt_text = "这是一段提示语音。"
    pipe.synthesize("你好。", prompt_wav=clip, max_new_tokens=16)  # warm
    torch.cuda.synchronize()
    print(f"cosy long: the 1.5B pairing built and warm in {time.perf_counter() - t0:.1f} s")
    a_token = sum(dm.launches_per_step(COSY_L).values())
    f1, f2 = pipe.frontend_zero_shot(clip), pipe.frontend_zero_shot(clip)
    same_frontend = all(np.array_equal(a, b) for a, b in zip(f1, f2))
    feats = dict(zip(("prompt_speech_tokens", "prompt_mel", "spk_embedding"), f1))
    out: dict = {"frontend_bit_identical": same_frontend}
    for lang, text in (("zh", LONG_ZH), ("en", LONG_EN)):
        norm = text_frontend.basic_normalize(text)
        host = text_frontend.split_paragraph(norm, pipe.tok.encode,
                                             token_max_n=LONG_MAX_N) or [norm]
        torch.cuda.synchronize()
        reset_all_launches()
        t = time.perf_counter()
        res = pipe.synthesize_long(text, prompt_text=prompt_text, prompt_wav=clip,
                                   seed=LONG_SEED, token_max_n=LONG_MAX_N,
                                   max_new_tokens=LONG_CAP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = all_launches()
        audio_s = len(res.wav) / res.sample_rate
        steps = [decoded_steps(pipe, c, prompt_text, n) for c, n in zip(res.chunks, res.chunk_tokens)]
        print(f"cosy long: {lang}: normalized: {norm}")
        for i, (c, n, s) in enumerate(zip(res.chunks, res.chunk_tokens, steps)):
            print(f"cosy long: {lang}: chunk {i} ({len(pipe.tok.encode(c))} text tokens, "
                  f"{n} speech tokens, {s} decode steps): {c}")
        print(f"cosy long: {lang}: {wall:.3f} s wall for {audio_s:.3f} s of audio on {card}: "
              f"frontend {res.frontend_s:.3f} s, LM {res.llm_s:.3f} s, flow {res.flow_s:.3f} s, "
              f"HiFT {res.vocoder_s:.3f} s; RTF {wall / audio_s:.4f} (without the frontend "
              f"{res.rtf:.4f}); launches {launches}")
        check(res.chunks == host, f"cosy long: {lang}: chunks {res.chunks} != the host's {host}")
        check(len(host) >= 2, f"cosy long: {lang}: one chunk only")
        up = pipe.hift_cfg.total_upsample * pipe.flow_cfg.token_mel_ratio
        check(bool(np.isfinite(res.wav).all()) and res.wav.shape == (len(res.speech_tokens) * up,),
              f"cosy long: {lang}: wav {res.wav.shape} for {len(res.speech_tokens)} tokens")
        want = {"wkv7_fwd": COSY_L * len(host), "decode_b1_step": a_token * sum(steps)}
        got = {k: launches[k] for k in want}
        check(got == want and launches["wkv7_step"] == 0,
              f"cosy long: {lang}: launches {launches}, want {want}")
        parts = [pipe.synthesize(c, prompt_text, None, seed=LONG_SEED + i,
                                 max_new_tokens=LONG_CAP, **feats) for i, c in enumerate(host)]
        ref_wav = np.concatenate([p.wav for p in parts])
        ref_tok = np.concatenate([p.speech_tokens for p in parts])
        same_tokens = np.array_equal(ref_tok, res.speech_tokens)
        err = (float(np.abs(ref_wav - res.wav).max() / np.abs(ref_wav).max())
               if ref_wav.shape == res.wav.shape else float("inf"))
        identical = same_tokens and err == 0.0
        print(f"cosy long: {lang}: vs the chunks' synthesize calls: tokens equal {same_tokens}, "
              f"wav max error {err:.3e} of its largest sample, bit-identical {identical} "
              f"(frontend bit-identical across calls: {same_frontend})")
        check(same_tokens and err <= 1e-5, f"cosy long: {lang}: not the chunks' synthesize calls")
        out[lang] = {"chunks": len(host), "chunk_tokens": res.chunk_tokens, "decode_steps": steps,
                     "wall_s": wall, "audio_s": audio_s, "rtf_wall": wall / audio_s,
                     "rtf": res.rtf, "frontend_s": res.frontend_s, "llm_s": res.llm_s,
                     "flow_s": res.flow_s, "hift_s": res.vocoder_s, "launches": got,
                     "bit_identical": identical}
    del pipe
    torch.cuda.empty_cache()
    return out


def marked_rows(seed: int, n: int, T: int):
    """spark_properties rows whose texts mix zh characters of the pinyin
    table and en words of the G2P dictionary, filling about T - MARK_ROOM
    positions (the room the marks take)."""
    import numpy as np

    from rwkvtts_torch.data import en_g2p, pinyin
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    tok = get_world_tokenizer()
    rng = np.random.default_rng(seed)
    zh, en = list(pinyin.pinyin_table())[:800], sorted(en_g2p.EXCEPTIONS)
    rows = []
    for i in range(n):
        parts = []
        for _ in range(int(rng.integers(4, 9))):
            if rng.random() < 0.5:
                parts.append("".join(rng.choice(zh, int(rng.integers(2, 6)))))
            else:
                parts.append(" ".join(rng.choice(en, int(rng.integers(1, 4)))))
        text = " ".join(parts)
        n_sem = T - 42 - len(tok.encode(text)) - MARK_ROOM
        rows.append({"text": text, "global_tokens": rng.integers(0, 4096, 32).tolist(),
                     "semantic_tokens": rng.integers(0, 8192, n_sem).tolist(),
                     "age": "youth-adult", "gender": ("female", "male")[i % 2],
                     "emotion": ("HAPPY", "NEUTRAL")[i % 2],
                     "pitch": float(rng.uniform(100, 260)), "speed": float(rng.uniform(2, 6))})
    return rows


def phase_long_train(dev, card: str) -> dict:
    """python -m rwkvtts_torch.train.cli --task spark_properties
    --mark-phonemes-prob 0.5 at 1024 x 24, 4 rows (8 sequences) a batch
    padded to 2048: one warm-up and TASK_TIMED timed steps. The CLI's
    first batch = collate_with_properties(rows, rng=random.Random(seed)) on
    the host; finite losses, none skipped; 2 L kernel-4 and L kernel-5
    launches a step. Prints ms a step, positions/s, peak memory and how
    many texts were marked."""
    import random

    import numpy as np

    from rwkvtts_torch.data import spark_collator, text_frontend
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.train import cli, trainer
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    Bn, L, n_steps = TASK_B // 2, TASK_L, TASK_WARM + 1 + TASK_TIMED
    seen, marked = [], [0]
    real_collate, real_mark = spark_collator.collate_with_properties, text_frontend.mark_phonemes
    real_save = trainer.Trainer.save

    def collate(rows, *a, **k):
        batch = real_collate(rows, *a, **k)
        seen.append((list(rows), batch))
        return batch

    def mark(*a, **k):
        marked[0] += 1
        return real_mark(*a, **k)

    spark_collator.collate_with_properties, text_frontend.mark_phonemes = collate, mark
    trainer.Trainer.save = lambda self, epoch, batch: None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "rows.jsonl")
            with open(data, "w") as f:
                for row in marked_rows(82, Bn * n_steps, TASK_T):
                    f.write(json.dumps(row) + "\n")
            run_dir = os.path.join(tmp, "run")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            wkv7_cuda.reset_launches()
            tr = cli.main(_task_cli_args("spark_properties", dev, data, run_dir, TASK_C, L, Bn,
                                         TASK_T, ("--mark-phonemes-prob", str(MARK_PROB),
                                                  "--seed", "0")))
            torch.cuda.synchronize()
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
    finally:
        spark_collator.collate_with_properties, text_frontend.mark_phonemes = real_collate, real_mark
        trainer.Trainer.save = real_save
    peak = torch.cuda.max_memory_allocated()
    launches = (wkv7_cuda.launches["wkv7_fused_fwd"], wkv7_cuda.launches["wkv7_fused_bwd"])
    losses = [r["loss"] for r in recs]
    t = [r["time"] for r in recs]
    step_s = (t[n_steps - 2] - t[TASK_WARM - 1]) / TASK_TIMED
    positions = [int(b["attention_mask"].sum()) for _, b in seen]
    rows0, batch0 = seen[0]
    want0 = real_collate(rows0, get_world_tokenizer(n_spct=64), 8192, pad_to=TASK_T,
                         mark_phonemes_prob=MARK_PROB, rng=random.Random(0))
    same = batch0.keys() == want0.keys() and all(np.array_equal(batch0[k], want0[k])
                                                 for k in want0)
    n_texts = Bn * len(seen)
    r = {"losses": losses, "step_ms": 1e3 * step_s,
         "positions_per_s": float(np.mean(positions)) / step_s, "positions_a_step": positions,
         "peak_gib": peak / 2**30, "texts": n_texts, "marked": marked[0],
         "fused_launches_a_step": [x / len(recs) for x in launches], "first_batch_equal": same}
    print(f"long train: spark_properties {TASK_C} x {L}, --mark-phonemes-prob {MARK_PROB}, {Bn} "
          f"rows (8 sequences of <= {TASK_T}) a step: losses {[round(x, 4) for x in losses]}; "
          f"{r['step_ms']:.2f} ms a step over {TASK_TIMED} steps, {r['positions_per_s']:.1f} "
          f"positions/s ({positions} a step), peak memory {r['peak_gib']:.2f} GiB on {card}; "
          f"{marked[0]} of {n_texts} texts marked; kernels 4 / 5 {launches} over {len(recs)} "
          f"steps; the first batch = the host's collate: {same}")
    check(same, "long train: the CLI's first batch is not the host's collate_with_properties")
    check(len(recs) == n_steps and all(math.isfinite(x) for x in losses)
          and sum(int(r["skipped"]) for r in recs) == 0, f"long train: steps {recs}")
    check(0 < marked[0] < n_texts, f"long train: {marked[0]} of {n_texts} texts marked")
    check(launches == (2 * L * len(recs), L * len(recs)),
          f"long train: kernels 4 / 5 {launches}, want {(2 * L * len(recs), L * len(recs))}")
    del tr
    torch.cuda.empty_cache()
    return r


def phase_seed_tts(dev, card: str) -> dict:
    """The seed-tts harness on a 4-row zh/meta.lst written to a temporary
    directory (6 s seeded 16 kHz prompt clips): generate_testset through
    phase 30's pipeline, evaluate_wer with asr_transcribe_fn at
    asr-0.4B-whisper-large-v3's widths (random, matrices bf16; 30 kernel-2
    and 24 x steps kernel-7 launches a transcribe), evaluate_sim with
    campplus_embed_fn on the pipeline's CAM++, whisper_transcribe_fn once
    on a tiny saved Whisper model. WER and SIM come from random weights."""
    import dataclasses

    import numpy as np

    from rwkvtts_torch.eval import seed_tts, sim
    from rwkvtts_torch.models import asr, whisper
    from rwkvtts_torch.utils import audio_io, fixtures
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    t0 = time.perf_counter()
    pipe = long_pipeline(dev)
    cfg = dataclasses.replace(asr.default_config(ASR_C, ASR_L, adapter_layers=ASR_ADAPTER_L),
                              whisper=whisper.WhisperEncoderConfig(**WHISPER_LARGE_V3))
    params = _bf16_matrices(asr.init_params(torch.Generator(device=dev).manual_seed(0), cfg))
    torch.cuda.synchronize()
    print(f"seed tts: the 1.5B pairing and asr-0.4B-whisper-large-v3 built in "
          f"{time.perf_counter() - t0:.1f} s")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "eval", "zh")
        os.makedirs(os.path.join(d, "prompt-wavs"))
        lines = []
        for i, text in enumerate(SEED_TEXTS[:SEED_ROWS]):
            audio_io.save_wav(os.path.join(d, "prompt-wavs", f"p{i}.wav"),
                              prompt_clip(ZS_PROMPT_S, seed=40 + i), 16000)
            lines.append(f"utt{i}|这是提示语音的文本。|prompt-wavs/p{i}.wav|{text}")
        with open(os.path.join(d, "meta.lst"), "w") as f:
            f.write("\n".join(lines) + "\n")
        pipe.synthesize("你好。", prompt_wav=prompt_clip(ZS_PROMPT_S, seed=40),
                        max_new_tokens=16)  # warm
        (wavs, synth_s) = _timed(lambda: seed_tts.generate_testset(
            pipe, os.path.join(tmp, "eval"), "zh", os.path.join(tmp, "out"),
            max_new_tokens=SEED_NEW, seed=3))
        rows = seed_tts.read_meta_lst(os.path.join(d, "meta.lst"))
        check([u for u, _ in wavs] == [r.utt_id for r in rows], f"seed tts: ids {wavs}")

        fn = seed_tts.asr_transcribe_fn(params, cfg, get_world_tokenizer(), lang="zh",
                                        max_new_tokens=SEED_ASR_NEW)
        per_call, times = [], []

        def counted(path):
            torch.cuda.synchronize()
            reset_all_launches()
            t = time.perf_counter()
            text = fn(path)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            per_call.append(all_launches())
            return text

        counted(wavs[0][1])  # warm
        per_call.clear(), times.clear()
        pairs = [(p, r.text) for (_, p), r in zip(wavs, rows)]
        res = seed_tts.evaluate_wer(pairs, "zh", counted)
        transcribe_s = list(times)
        n_ref = sum(len(seed_tts.normalize_text(r.text, "zh")) for r in rows)
        want = {"wkv7_fwd": ASR_ADAPTER_L + ASR_L, "wkv7_step": ASR_L * SEED_ASR_NEW}
        got = [{k: c[k] for k in want} for c in per_call]
        print(f"seed tts: generate_testset {len(wavs)} rows in {synth_s:.3f} s "
              f"({1e3 * synth_s / len(wavs):.1f} ms a row); transcribe "
              f"{1e3 * np.mean(transcribe_s):.1f} ms a row; WER (random weights) {res}; "
              f"launches a transcribe {got} (want {want}) on {card}")
        check(all(math.isfinite(res[k]) for k in ("wer", "substitutions", "deletions",
                                                   "insertions")), f"seed tts: WER {res}")
        check(res["n_ref_tokens"] == n_ref, f"seed tts: n_ref_tokens {res['n_ref_tokens']} "
              f"!= normalize_text's {n_ref}")
        check(len(got) == len(rows) and all(g == want for g in got),
              f"seed tts: launches a transcribe {got}, want {want}")

        embed = sim.campplus_embed_fn(pipe.campplus_params, pipe.campplus_cfg)
        embed(audio_io.load_wav(wavs[0][1], 16000))  # warm
        clips = [(audio_io.load_wav(p, 16000),
                  audio_io.load_wav(os.path.join(d, r.prompt_wav), 16000))
                 for (_, p), r in zip(wavs, rows)]
        sres, sim_s = _timed(lambda: sim.evaluate_sim(clips, embed))
        vals = sres.per_utt + sres.per_utt_centered
        print(f"seed tts: SIM (random weights) mean {sres.mean:.4f} centered "
              f"{sres.centered_mean:.4f} per utterance {[round(v, 4) for v in sres.per_utt]}; "
              f"embed {1e3 * sim_s / (2 * len(clips)):.1f} ms a wav")
        check(all(-1.0 - 1e-9 <= v <= 1.0 + 1e-9 for v in vals), f"seed tts: SIM {vals}")

        wdir = fixtures.write_tiny_whisper(os.path.join(tmp, "whisper"))
        wfn = seed_tts.whisper_transcribe_fn(wdir, "zh", device=dev)
        text, w_s = _timed(lambda: wfn(wavs[0][1]))
        print(f"seed tts: whisper_transcribe_fn on a tiny saved Whisper model ({dev}): "
              f"{text!r} in {1e3 * w_s:.1f} ms")
        check(isinstance(text, str), "seed tts: whisper_transcribe_fn")
        out = {"rows": len(wavs), "synthesize_ms_a_row": 1e3 * synth_s / len(wavs),
               "transcribe_ms_a_row": 1e3 * float(np.mean(transcribe_s)),
               "embed_ms_a_wav": 1e3 * sim_s / (2 * len(clips)), "wer": res,
               "sim_mean": sres.mean, "sim_centered_mean": sres.centered_mean,
               "launches_a_transcribe": got[0], "whisper_ms": 1e3 * w_s}
    del pipe, params
    torch.cuda.empty_cache()
    return out


def phase_ranking_demo(dev, card: str) -> dict:
    """rwkvtts_torch.eval.ranking_demo.run on the card at the JAX test's
    sizes (8 sentences, 300 + 300 steps): trained WER < 0.35, untrained
    WER > 0.7, the gap > 0.4 (tests/test_ranking_demo.py:10-18); launches
    of the kernels its training, synthesis and transcription drive
    (kernels 4-5 and 7; the fused-prep configs prefill on kernel 4)."""
    from rwkvtts_torch.eval import ranking_demo

    reset_all_launches()
    with tempfile.TemporaryDirectory() as tmp:
        res = ranking_demo.run(n_sentences=RANK_SENTENCES, tts_steps=RANK_STEPS,
                               asr_steps=RANK_STEPS, out_dir=tmp, verbose=True, device=dev)
    torch.cuda.synchronize()
    res["launches"] = all_launches()
    print(f"ranking demo: trained WER {res['trained']:.3f}, untrained {res['untrained']:.3f}, "
          f"final losses tts {res['tts_loss']:.4f} / asr {res['asr_loss']:.4f}, "
          f"{res['seconds']:.1f} s on {card}; launches {res['launches']}")
    check(res["trained"] < 0.35 and res["untrained"] > 0.7
          and res["untrained"] - res["trained"] > 0.4, f"ranking demo: {res}")
    # training on the fused pair; the prefills of synthesis and transcription
    # take the fused forward too (the demo's configs set wkv_fuse_prep), the
    # decode steps kernel 7
    for k in ("wkv7_fused_fwd", "wkv7_fused_bwd", "wkv7_step"):
        check(res["launches"][k] > 0, f"ranking demo: no {k} launch")
    return res


def phase_spark_generate(dev, card: str) -> dict:
    """greedy_spark_generate at spark.default_config(1024, 24) (random,
    matrices bf16, the decode-packed tree), B = 8 left-padded 128-token
    prompts, GREEDY_NEW new tokens: the tokens = spark_generate at top-k 1 on
    greedy's generator seed (on another seed, where bf16 logits tie at the
    top, the draws part: reported); kernel 2 24 launches, kernel 7 24 a decode step
    (GREEDY_NEW steps: every draw's step runs, the last one's too, as in JAX's
    scan); ms a token."""
    from rwkvtts_torch.infer import generate as gen
    from rwkvtts_torch.models import rwkv7, spark

    cfg = spark.default_config(hidden_size=GREEDY_C, num_layers=GREEDY_L)
    params = _bf16_matrices(spark.init_params(torch.Generator(device=dev).manual_seed(0), cfg))
    packed = rwkv7.pack_decode_params(params, cfg.backbone)
    g = torch.Generator().manual_seed(8)
    tokens, modality, mask = (x[:GREEDY_B].to(dev) for x in left_padded_prompt(g, GREEDY_PROMPT))
    args = (packed, cfg, tokens, modality, mask)
    gen.greedy_spark_generate(*args, max_new_tokens=4)  # warm
    reset_all_launches()
    (toks, lengths), wall = _timed(lambda: gen.greedy_spark_generate(
        *args, max_new_tokens=GREEDY_NEW))
    launches = all_launches()
    # top-k 1 keeps every logit tied with the largest, and the draw's noise
    # picks among them: spark_generate at greedy's settings and generator seed
    # gives its tokens; a second greedy call shows that the loop is
    # deterministic, and another seed how soon the bf16 logits tie at the top
    first_diff = lambda a: (lambda d: int(d[0]) if len(d) else None)((a != toks).any(0).nonzero())
    again, _ = gen.greedy_spark_generate(*args, max_new_tokens=GREEDY_NEW)
    other, _ = gen.spark_generate(*args, max_new_tokens=GREEDY_NEW, top_k=1, top_p=1.0,
                                  temperature=1e-6,
                                  generator=torch.Generator(device=dev).manual_seed(0))
    reseeded, _ = gen.spark_generate(*args, max_new_tokens=GREEDY_NEW, top_k=1, top_p=1.0,
                                     temperature=1e-6,
                                     generator=torch.Generator(device=dev).manual_seed(7))
    firsts = {"second_greedy_call": first_diff(again), "spark_generate_top_k1": first_diff(other),
              "another_seed": first_diff(reseeded)}
    same = firsts["spark_generate_top_k1"] is None
    r = {"B": GREEDY_B, "prompt": GREEDY_PROMPT, "new": GREEDY_NEW, "wall_s": wall,
         "ms_a_token": 1e3 * wall / GREEDY_NEW, "tok_s": GREEDY_B * GREEDY_NEW / wall,
         "lengths": lengths.tolist(), "launches": launches, "equal_top_k1": same,
         "first_step_that_differs": firsts}
    print(f"spark generate: greedy_spark_generate {GREEDY_C} x {GREEDY_L} bf16, B={GREEDY_B}, "
          f"{GREEDY_PROMPT} + {GREEDY_NEW} tokens: {wall:.3f} s, {r['ms_a_token']:.2f} ms a "
          f"token ({r['tok_s']:.1f} tok/s), lengths {r['lengths']}, launches {launches}; "
          f"the first step where a row differs from it (None: none): {firsts} on {card}")
    check(same, "spark generate: greedy != spark_generate at top-k 1")
    want = {"wkv7_fwd": GREEDY_L, "wkv7_step": GREEDY_L * GREEDY_NEW}
    check({k: launches[k] for k in want} == want and launches["decode_b64_step"] == 0,
          f"spark generate: launches {launches}, want {want}")
    del params, packed
    torch.cuda.empty_cache()
    return r


def long_of_tree(what: str = "long", phases=None) -> dict:
    """Phases 30-34 alone (or the named ones of them) with whichever
    rwkvtts_torch is imported, TF32 off; prints their numbers and each
    phase's seconds as one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {}
    for fn in (phase_cosy_long, phase_long_train, phase_seed_tts, phase_ranking_demo,
               phase_spark_generate):
        if phases is None or fn.__name__ in phases:
            t = time.perf_counter()
            out[fn.__name__] = fn(dev, card)
            out[fn.__name__ + "_s"] = round(time.perf_counter() - t, 1)
    print(f"{what}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# 35-38. Training from raw audio: corpus -> tokens -> training -> export
# ---------------------------------------------------------------------------

# phase 35: a seeded corpus of 64 utterances at 16 kHz, 3-20 s each, written by
# the port's write_shards in 4 shards of 16 (pcm16 wav + json: text, speaker,
# language, the five speaker properties)
CORPUS_N, CORPUS_PER_SHARD, CORPUS_S, CORPUS_SR = 64, 16, (3.0, 20.0), 16000
CORPUS_TEXTS = ("今天的天气非常好，我们一起去公园散步吧。", "人工智能正在改变世界，语音合成技术让机器开口说话。",
                "请在下午三点之前把报告发给我。", "这家餐厅的菜很好吃，价格也不贵。",
                "The quick brown fox jumps over the lazy dog by the river bank.",
                "Please call me when you arrive at the station tomorrow morning.",
                "We expect more than one hundred people to attend the meeting.",
                "Reading a good book on a rainy afternoon is a simple pleasure.")
# the host C++ libraries of rwkvtts_torch/csrc/ (utils/native.py builds them)
HOST_LIBRARIES = ("tar_stream", "world_tokenizer")
# the cut shard: shard 0 cut half way into its sixth member (sample 2's json)
CORPUS_CUT_MEMBER = 5
# phase 37: Spark 1024 x 24 from the tars, B = 8 rows padded to 2048, the
# warm-up, the timed steps and the step the CLI's metrics lag adds
WDS_B, WDS_T, WDS_STEPS = 8, 2048, TASK_WARM + 1 + TASK_TIMED
# the steps profiled with and without the inline tokenization
WDS_PROFILED = 3
# phase 36: CAM++ x-vector rows of at most 2 clips a speaker (the reference's
# cap is 10 a speaker and language; 2 keeps the eager CAM++ to 16 clips)
CAMPPLUS_CAP = 2
# phase 38: the export's logits against the Spark model's, bf16 (the gates' 2e-2)
EXPORT_TOL = 2e-2


def corpus_samples(seed: int = 35) -> list:
    """CORPUS_N utterances: a voiced tone (5 harmonics of a gliding f0, a
    syllable-rate envelope) and a little noise, texts from CORPUS_TEXTS,
    8 speakers, the five properties spark_properties reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(CORPUS_N):
        n = int(rng.uniform(*CORPUS_S) * CORPUS_SR)
        t = np.arange(n) / CORPUS_SR
        f0 = rng.uniform(90, 260) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t))
        phase = 2 * np.pi * np.cumsum(f0) / CORPUS_SR
        env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * rng.uniform(2, 5) * t))
        wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * env * 0.25
        wav = (wav + 0.01 * rng.standard_normal(n)).astype(np.float32)
        text = CORPUS_TEXTS[i % len(CORPUS_TEXTS)]
        out.append({"__key__": f"utt{i:04d}", "audio": np.clip(wav, -1, 1), "text": text,
                    "speaker": f"spk{i % 8}", "language": "zh" if ord(text[0]) > 127 else "en",
                    "age": ("youth-adult", "middle-aged")[i % 2],
                    "gender": ("female", "male")[(i // 2) % 2],
                    "emotion": ("NEUTRAL", "HAPPY", "SAD")[i % 3],
                    "pitch": float(rng.uniform(100, 260)), "speed": float(rng.uniform(2, 6))})
    return out


def _same_samples(a: list, b: list) -> bool:
    import numpy as np

    if [s["__key__"] for s in a] != [s["__key__"] for s in b]:
        return False
    for x, y in zip(a, b):
        if x.keys() != y.keys():
            return False
        for k in x:
            if isinstance(x[k], np.ndarray):
                if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k]):
                    return False
            elif x[k] != y[k]:
                return False
    return True


def phase_corpus(dev, card: str, work: str) -> dict:
    """The corpus side on the host: g++ of the tar streamer and the trie
    (timed, where this process built them), the seeded corpus through
    write_shards, stream_tars (the C++ streamer) = read_tars_plain (its
    tarfile version: keys, texts, bit-identical audio) with each one's
    MB/s, a shard cut inside a member (each whole sample once on both, the
    cut sample dropped), the trie's ids = the plain Python matcher's on the
    corpus texts and each one's encode ms."""
    import tarfile

    from rwkvtts_torch.data import corpus_tools, webdataset
    from rwkvtts_torch.utils import native
    from rwkvtts_torch.utils.profiling import PhaseTimer
    from rwkvtts_torch.utils.tokenizer import WorldTokenizer

    timer = PhaseTimer()
    for name in HOST_LIBRARIES:
        native.load(name)
    builds = {k: round(v, 3) for k, v in native.build_seconds.items()}
    with timer.phase("write shards"):
        shards = corpus_tools.write_shards(corpus_samples(), os.path.join(work, "shards"),
                                           samples_per_shard=CORPUS_PER_SHARD)
    mb = sum(os.path.getsize(p) for p in shards) / 1e6
    readers = {True: webdataset.stream_tars, False: webdataset.read_tars_plain}
    streams = {}
    for native_path, read in readers.items():
        with timer.phase(read.__name__):
            streams[native_path] = list(read(shards))
    same = _same_samples(streams[True], streams[False])
    audio_s = sum(len(s["audio"]) for s in streams[True]) / CORPUS_SR
    rate = {k: mb / timer.stats[read.__name__].seconds for k, read in readers.items()}

    cut = os.path.join(work, "cut.tar")
    with tarfile.open(shards[0]) as tf:
        m = [m for m in tf if m.isfile()][CORPUS_CUT_MEMBER]
    with open(shards[0], "rb") as f:
        data = f.read(m.offset_data + m.size // 2)
    with open(cut, "wb") as f:
        f.write(data)
    cut_runs = {k: list(read([cut, shards[1]])) for k, read in readers.items()}
    whole = CORPUS_CUT_MEMBER // 2
    want_keys = ([f"utt{i:04d}" for i in range(whole)]
                 + [f"utt{i:04d}" for i in range(CORPUS_PER_SHARD, 2 * CORPUS_PER_SHARD)])
    cut_keys = [s["__key__"] for s in cut_runs[True]]
    cut_same = _same_samples(cut_runs[True], cut_runs[False])

    tok = WorldTokenizer()
    texts = [s["text"] for s in streams[True]]
    ids = {}
    for encode, name in ((tok.encode, "trie"), (tok.encode_plain, "python")):
        with timer.phase(f"encode {name}"):
            for _ in range(10):
                ids[name] = [encode(t) for t in texts]
    enc_ms = {k: 1e3 * timer.stats[f"encode {k}"].seconds / 10 for k in ("trie", "python")}
    r = {"g++_s": builds, "shards": len(shards), "samples": len(streams[True]), "mb": mb,
         "audio_s": audio_s, "native_mb_per_s": rate[True], "tarfile_mb_per_s": rate[False],
         "native_equals_tarfile": same, "cut_keys": cut_keys, "cut_paths_equal": cut_same,
         "trie_equals_python": ids["trie"] == ids["python"],
         "encode_ms_a_pass": enc_ms, "timer": timer.summary()}
    print(f"corpus: g++ {builds} s; {len(shards)} shards, {len(streams[True])} utterances, "
          f"{audio_s:.1f} s of audio, {mb:.1f} MB; stream_tars (C++ streamer) {rate[True]:.1f} "
          f"MB/s, read_tars_plain (tarfile) {rate[False]:.1f} MB/s (both decode the wavs), the "
          f"same samples (keys, "
          f"texts, bit-identical audio): {same}")
    print(f"corpus: shard 0 cut half way into member {CORPUS_CUT_MEMBER}: {cut_keys[:whole + 1]} "
          f"... ({len(cut_keys)} samples), streamer = tarfile: {cut_same}; the cut sample "
          f"utt{whole:04d} is dropped by both")
    print(f"corpus: the trie's ids = the Python matcher's on the {len(texts)} texts: "
          f"{r['trie_equals_python']}; encode of the {len(texts)} texts: trie "
          f"{enc_ms['trie']:.3f} ms, Python {enc_ms['python']:.3f} ms (host, on {card})")
    check(same, "corpus: the C++ streamer's samples differ from tarfile's")
    check(len(streams[True]) == CORPUS_N, f"corpus: {len(streams[True])} samples")
    check(cut_keys == want_keys and cut_same, f"corpus: the cut shard gave {cut_keys}")
    check(r["trie_equals_python"], "corpus: the trie's ids differ from the Python matcher's")
    return {**r, "shard_paths": shards}


def extract_configs():
    """The codecs of phase 36 at their published widths: BiCodec with the
    xlsr-53-shaped frontend, XY_Tokenizer, Higgs with a hubert-base-shaped
    teacher, S3 and CAM++."""
    from transformers import HubertConfig

    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import higgs
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.codecs import xy_tokenizer as xt

    return {"bicodec": wav_codec_config(), "wav2vec2": xlsr53_config(),
            "xy": xt.XYTokenizerConfig(), "higgs": higgs.HiggsConfig(),
            "hubert": HubertConfig(), "s3": s3.S3TokenizerConfig(), "campplus": cp.CampplusConfig()}


def phase_extract(dev, card: str, work: str, shards: list) -> dict:
    """The offline extractors over the corpus on the card: BiCodec
    (extract_spark_tokens, one utterance at a time; then run_sharded with 2
    spawned workers reading the written model directory = the same rows),
    XY_Tokenizer (batches of 8 padded to 30 s), Higgs (batches of 4, the
    HuBERT teacher of a saved random hubert-base), S3 rows and CAM++
    x-vector rows. Each codec's ms per audio second (after a warm-up batch),
    rows' shapes and ranges."""
    import threading

    import numpy as np
    from transformers import HubertModel

    from rwkvtts_torch.codecs import bicodec, campplus as cp, higgs
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.codecs import xy_tokenizer as xt
    from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer, Wav2Vec2Frontend
    from rwkvtts_torch.data import corpus_tools, extract, webdataset
    from rwkvtts_torch.utils.profiling import PhaseTimer

    cfgs = extract_configs()
    samples = list(webdataset.stream_tars(shards))
    audio_s = sum(len(s["audio"]) for s in samples) / CORPUS_SR
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    timer = PhaseTimer()
    out_dir = os.path.join(work, "rows")
    os.makedirs(out_dir, exist_ok=True)
    rows_of = lambda name: [json.loads(line) for line in open(os.path.join(out_dir, name))]

    # BiCodec, and its model directory for phase 37 and the workers
    codec = SparkAudioTokenizer(cfgs["bicodec"], bicodec.init_params(gen(0), cfgs["bicodec"]),
                                Wav2Vec2Frontend.from_config(cfgs["wav2vec2"], seed=0, device=dev))
    codec_dir = os.path.join(work, "Spark-TTS")
    with timer.phase("write model dir"):
        codec.save_pretrained(codec_dir)
    dir_gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(codec_dir)
                 for f in fs) / 1e9
    codec.tokenize(samples[0]["audio"])
    keyed = lambda s: {"__key__": s["__key__"]}
    with timer.phase("bicodec", audio_seconds=audio_s):
        extract.extract_spark_tokens(samples, codec, os.path.join(out_dir, "spark.jsonl"), keyed)
    spark_rows = rows_of("spark.jsonl")
    del codec
    torch.cuda.empty_cache()

    # the 2 spawned workers start (a CUDA context, the model directory read)
    # while this process builds the other codecs; they are joined before
    # those are timed
    sharded_run = {}

    def sharded_job():
        with timer.phase("run_sharded 2 workers"):
            sharded_run["rows"] = extract.run_sharded(
                shards, extract.SparkTarWorker(codec_dir, device=str(dev),
                                               properties=("__key__",)),
                os.path.join(work, "sharded"), num_workers=2)

    job = threading.Thread(target=sharded_job)
    job.start()

    def warm_then_time(name, fn, warm):
        fn(warm, os.path.join(out_dir, f"warm_{name}.jsonl"))
        torch.cuda.synchronize()
        with timer.phase(name, audio_seconds=audio_s):
            n = fn(samples, os.path.join(out_dir, f"{name}.jsonl"))
            torch.cuda.synchronize()
        return n

    xcfg, hcfg, s3cfg, ccfg = cfgs["xy"], cfgs["higgs"], cfgs["s3"], cfgs["campplus"]
    xp, hp = xt.init_params(gen(1), xcfg), higgs.init_params(gen(2), hcfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        HubertModel(cfgs["hubert"]).save_pretrained(os.path.join(work, "hubert"))
    teacher = higgs.hubert_feature_fn(os.path.join(work, "hubert"), device=dev)
    s3p, cpp = s3.init_params(gen(3), s3cfg), cp.init_params(gen(4), ccfg)
    on_card = lambda w: torch.from_numpy(np.asarray(w, np.float32))[None].to(dev)
    s3fn = lambda w: s3.tokenize(s3p, s3cfg, on_card(w))[0].cpu().numpy()
    embed = lambda w: cp.embed_wav(cpp, ccfg, on_card(w))[0].cpu().numpy()
    job.join()
    n_sharded = sharded_run.get("rows", 0)
    sharded = [json.loads(line) for p in shards
               for line in open(os.path.join(work, "sharded", os.path.basename(p) + ".jsonl"))]

    warm_then_time("xy", lambda s, o: extract.extract_xy_tokens(s, xcfg, xp, o), samples[:8])
    warm_then_time("higgs", lambda s, o: extract.extract_higgs_tokens(s, hcfg, hp, teacher, o),
                   samples[:4])
    warm_then_time("s3", lambda s, o: extract.extract_cosy_tokens(s, s3fn, o), samples[:1])
    # x-vector rows, at most CAMPPLUS_CAP a speaker and language (8 speakers)
    embed(samples[0]["audio"])
    xrow = corpus_tools.xvector_row_fn(embed, per_speaker_cap=CAMPPLUS_CAP)
    t = time.perf_counter()
    xvec, xvec_audio = [], 0
    for smp in samples:
        r = xrow(smp)
        if r is not None:
            xvec.append(r)
            xvec_audio += len(smp["audio"])
    torch.cuda.synchronize()
    timer.stats["campplus"].calls, timer.stats["campplus"].seconds = 1, time.perf_counter() - t
    timer.stats["campplus"].audio_seconds = xvec_audio / CORPUS_SR
    del xp, hp, teacher, s3p, cpp
    torch.cuda.empty_cache()

    xy_rows, higgs_rows, s3_rows = rows_of("xy.jsonl"), rows_of("higgs.jsonl"), rows_of("s3.jsonl")
    lens = [len(s["audio"]) for s in samples]

    def frames(n: int) -> int:  # the wav2vec2 feature extractor's output length
        for k, st in zip(cfgs["wav2vec2"].conv_kernel, cfgs["wav2vec2"].conv_stride):
            n = (n - k) // st + 1
        return n

    ms = {k: 1e3 * v.rtf for k, v in timer.stats.items() if v.audio_seconds}
    ok = {
        "bicodec": len(spark_rows) == CORPUS_N and all(
            len(r["global_tokens"]) == 32 and len(r["semantic_tokens"]) == frames(n)
            and 0 <= min(r["semantic_tokens"]) and max(r["semantic_tokens"]) < 8192
            for r, n in zip(spark_rows, lens)),
        "xy": [np.shape(r["audio_tokens"]) for r in xy_rows] == [
            (xcfg.nq, max(min(n, 30 * CORPUS_SR) // 1280, 1)) for n in lens],
        "higgs": [np.shape(r["audio_tokens"]) for r in higgs_rows] == [
            (hcfg.nq, max(n // hcfg.hop_length, 1)) for n in lens],
        "s3": len(s3_rows) == CORPUS_N and all(
            0 < len(r["tts_speech_tokens"]) and max(r["tts_speech_tokens"]) < s3cfg.vocab_size
            for r in s3_rows),
        "campplus": len(xvec) == 8 * CAMPPLUS_CAP and all(
            len(r["embedding"]) == ccfg.embedding_size and np.isfinite(r["embedding"]).all()
            for r in xvec),
    }
    r = {"audio_s": audio_s, "ms_per_audio_s": ms, "rows_ok": ok,
         "sharded_rows": n_sharded, "sharded_equal": sharded == spark_rows,
         "model_dir_gb": dir_gb, "timer": timer.summary()}
    print(f"extract: {CORPUS_N} utterances, {audio_s:.1f} s of audio on {card}: ms per audio "
          f"second " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"; rows' shapes and "
          f"ranges {ok}")
    print(f"extract: the model directory ({dir_gb:.2f} GB) written in "
          f"{timer.stats['write model dir'].seconds:.2f} s; run_sharded, 2 spawned workers: "
          f"{n_sharded} rows in {timer.stats['run_sharded 2 workers'].seconds:.2f} s, = the "
          f"single-process rows: {r['sharded_equal']}")
    check(all(ok.values()), f"extract: rows {ok}")
    check(r["sharded_equal"] and n_sharded == CORPUS_N,
          "extract: run_sharded's rows differ from the single-process rows")
    return {**r, "codec_dir": codec_dir,
            "spark_tokens": {row["__key__"]: (row["global_tokens"], row["semantic_tokens"])
                             for row in spark_rows}}


def phase_train_wds(dev, card: str, work: str, shards: list, extracted: dict) -> dict:
    """python -m rwkvtts_torch.train.cli --task spark --data-format webdataset
    --codec-dir <phase 36's directory> at 1024 x 24, B = 8 rows padded to
    2048, one warm-up and TASK_TIMED timed steps: every row's inline tokens
    = phase 36's extracted row of its key, 2 L / L fused launches a step,
    no step skipped. The inline tokenization's ms and the step's apart,
    positions/s, peak memory, and the card's busy share with and without
    the inline tokenization in front (WDS_PROFILED steps each under
    torch.profiler, CUDA activity only).
    Then one spark_properties step over the same tars: its batch is
    collate_with_properties' (two sequences a row, SPCT tokens)."""
    import functools

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from rwkvtts_torch.data import inline_spark, spark_collator
    from rwkvtts_torch.models.spark import MOD_TEXT
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.train import cli, trainer
    from rwkvtts_torch.utils.profiling import PhaseTimer
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    L, timer = TASK_L, PhaseTimer()
    seen, batches, props, held = {}, [], [], {}
    real = (inline_spark.tokenize_rows, spark_collator.collate_plain,
            spark_collator.collate_with_properties, cli.inline_codec, cli.load_rows,
            trainer.Trainer.save)

    def tokenize_rows(rows, codec):
        with timer.phase("inline tokenize"):
            out = real[0](rows, codec)
        seen.update({r["__key__"]: (r["global_tokens"], r["semantic_tokens"]) for r in out})
        return out

    def collate_plain(rows, *a, **k):
        with timer.phase("collate"):
            batch = real[1](rows, *a, **k)
        batches.append(batch)
        return batch

    def collate_with_properties(rows, *a, **k):
        batch = real[2](rows, *a, **k)
        props.append(batch)
        return batch

    def inline_codec(d, device):
        held["codec"] = real[3](d, device)
        return held["codec"]

    def load_rows(args):
        held["rows"] = real[4](args)
        return held["rows"]

    (inline_spark.tokenize_rows, spark_collator.collate_plain,
     spark_collator.collate_with_properties, cli.inline_codec, cli.load_rows) = (
        tokenize_rows, collate_plain, collate_with_properties, inline_codec, load_rows)
    trainer.Trainer.save = lambda self, epoch, batch: None
    data = os.path.join(os.path.dirname(shards[0]), "*.tar")
    wds = ("--data-format", "webdataset", "--codec-dir", extracted["codec_dir"], "--seed", "0")
    try:
        run_dir = os.path.join(work, "run")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wkv7_cuda.reset_launches()
        t0 = time.perf_counter()
        tr = cli.main(_task_cli_args("spark", dev, data, run_dir, TASK_C, L, WDS_B, WDS_T,
                                     wds + ("--max-rows", str(WDS_B * WDS_STEPS))))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = (wkv7_cuda.launches["wkv7_fused_fwd"], wkv7_cuda.launches["wkv7_fused_bwd"])
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        per_call = {k: 1e3 * v.seconds / v.calls for k, v in timer.stats.items()}
        n_seen = len(seen)

        # the card's busy share with the inline tokenization in front and on
        # batches made before: WDS_PROFILED steps each under torch.profiler
        # (CUDA activity only, the lightest trace), the same rows both times
        tok = get_world_tokenizer()
        collate = inline_spark.inline_collate(functools.partial(
            real[1], tokenizer=tok, eos_id=8192, pad_to=WDS_T), held["codec"])
        rows = held["rows"]
        ready = [tr.to_device(collate(rows[i * WDS_B:(i + 1) * WDS_B]))
                 for i in range(WDS_PROFILED)]
        shares = {}
        for name in ("inline", "ready"):
            state = tr.state
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for i in range(WDS_PROFILED):
                    batch = (tr.to_device(collate(rows[i * WDS_B:(i + 1) * WDS_B]))
                             if name == "inline" else ready[i])
                    state, m = tr.step_fn(state, batch, tr.generator)
                m["loss"].item()
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t1
            shares[name] = {**trace_numbers(prof, prof_wall, kernels="wkv7_fused"),
                            "wall_s": prof_wall}
            tr.state = state
        params, cfg = tr.state.params, tr.model_cfg
        del tr
        torch.cuda.empty_cache()

        # one spark_properties step over the same tars
        wkv7_cuda.reset_launches()
        tr = cli.main(_task_cli_args("spark_properties", dev, data, os.path.join(work, "props"),
                                     TASK_C, L, WDS_B // 2, WDS_T,
                                     wds + ("--max-rows", str(WDS_B // 2), "--dry-run")))
        torch.cuda.synchronize()
        props_launches = (wkv7_cuda.launches["wkv7_fused_fwd"],
                          wkv7_cuda.launches["wkv7_fused_bwd"])
        del tr
        torch.cuda.empty_cache()
    finally:
        (inline_spark.tokenize_rows, spark_collator.collate_plain,
         spark_collator.collate_with_properties, cli.inline_codec, cli.load_rows,
         trainer.Trainer.save) = real

    n_steps = len(recs)
    losses = [r["loss"] for r in recs]
    t = [r["time"] for r in recs]
    step_s = (t[n_steps - 2] - t[TASK_WARM - 1]) / TASK_TIMED
    positions = [int(b["attention_mask"].sum()) for b in batches[:n_steps]]
    tok_ms, col_ms = per_call["inline tokenize"], per_call["collate"]
    mismatched = [k for k, v in seen.items() if extracted["spark_tokens"][k] != v]
    pb = props[0] if props else {}
    spct = bool(props) and bool(((pb["tokens"] >= 65536) & (pb["modality"] == MOD_TEXT)).any())
    want = (2 * L * n_steps, L * n_steps)
    r = {"losses": losses, "step_ms": 1e3 * step_s, "inline_tokenize_ms_a_step": tok_ms,
         "collate_ms_a_step": col_ms, "train_step_ms": 1e3 * step_s - tok_ms - col_ms,
         "positions_per_s": float(np.mean(positions)) / step_s, "positions_a_step": positions,
         "peak_gib": peak / 2**30, "wall_s": wall, "rows_tokenized": n_seen,
         "tokens_equal_extracted": not mismatched,
         "fused_launches_a_step": [x / n_steps for x in launches],
         "profiled": shares, "spark_properties": {
             "batch_sequences": int(pb["tokens"].shape[0]) if props else 0, "spct": spct,
             "fused_launches": props_launches}}
    print(f"train wds: spark {TASK_C} x {L} from {len(shards)} tars with --codec-dir, {WDS_B} rows "
          f"a step padded to {WDS_T}: losses {[round(x, 4) for x in losses]}; {r['step_ms']:.2f} "
          f"ms a step over {TASK_TIMED} steps, of it the inline tokenization {tok_ms:.2f} ms and "
          f"the collate {col_ms:.2f} ms, so the train step {r['train_step_ms']:.2f} ms; "
          f"{r['positions_per_s']:.1f} positions/s ({positions} a step), peak memory "
          f"{r['peak_gib']:.2f} GiB on {card}")
    for name, s in shares.items():
        per_step = lambda x: 1e3 * x / WDS_PROFILED
        print(f"train wds: {WDS_PROFILED} steps {name}, profiled: {per_step(s['wall_s']):.2f} ms "
              f"a step, the device busy {per_step(s['device_busy_s']):.2f} ms a step = "
              f"{s['device_busy_share']:.3f}, {s['device_ops']} device ops, syncs {s['syncs']}; "
              f"kernels 4-5 device ms a launch {s['device_ms_a_launch']}")
    print(f"train wds: {n_seen} rows tokenized inline, each = phase 36's extracted row of "
          f"its key: {not mismatched}; kernels 4 / 5 {launches} over {n_steps} steps; "
          f"spark_properties over the tars: {r['spark_properties']}")
    check(not mismatched, f"train wds: inline tokens differ from the extracted rows: {mismatched}")
    check(n_seen == WDS_B * n_steps, f"train wds: {n_seen} rows tokenized")
    check(n_steps == WDS_STEPS and all(math.isfinite(x) for x in losses)
          and sum(int(x["skipped"]) for x in recs) == 0, f"train wds: steps {recs}")
    check(launches == want, f"train wds: kernels 4 / 5 {launches}, want {want}")
    check(spct and pb["tokens"].shape[0] == WDS_B and props_launches == (2 * L, L),
          f"train wds: spark_properties {r['spark_properties']}")
    return {**r, "params": params, "cfg": cfg}


def phase_export(dev, card: str, work: str, trained: dict, extracted: dict) -> dict:
    """The trained Spark parameters through spark_to_flat, then
    blinkdl_to_rwkv7 as a flat-vocabulary model on the card: its logits on
    flat_ids_from_parts' ids of a training row = the Spark model's semantic
    logits within EXPORT_TOL of their largest (bf16 both), zeros beyond;
    the launches of the two forwards; cast_fp32_to_bf16 of the export."""
    import dataclasses

    from rwkvtts_torch import bridge
    from rwkvtts_torch.convert import rwkv7_ckpt, speech_init
    from rwkvtts_torch.data import spark_collator
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.utils.profiling import PhaseTimer
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    timer = PhaseTimer()
    params, cfg = trained["params"], trained["cfg"]
    with timer.phase("spark_to_flat"):
        flat = speech_init.spark_to_flat(params, cfg)
    fcfg = dataclasses.replace(cfg.backbone, vocab_size=flat["emb.weight"].shape[0])
    with timer.phase("load flat"):
        fparams = bridge.params_from_numpy(rwkv7_ckpt.blinkdl_to_rwkv7(flat, fcfg), dev)
    key = sorted(extracted["spark_tokens"])[0]
    glob, sem = extracted["spark_tokens"][key]
    text = CORPUS_TEXTS[int(key[3:]) % len(CORPUS_TEXTS)]
    tok = get_world_tokenizer()
    batch = spark_collator.collate_plain([{"text": text, "global_tokens": glob,
                                           "semantic_tokens": sem}], tok, 8192)
    t_ids, g_ids, s_ids = speech_init.flat_ids_from_parts(tok.encode(text), glob, sem)
    tag = speech_init.FLAT_TAG_BASE
    ids = ([tag + spark.TAG_START_TTS] + t_ids + [tag + spark.TAG_GLOBAL] + g_ids
           + [tag + spark.TAG_SEMANTIC] + s_ids)
    tokens = torch.from_numpy(batch["tokens"][:, :len(ids)]).to(dev)
    modality = torch.from_numpy(batch["modality"][:, :len(ids)]).to(dev)
    reset_all_launches()
    with torch.no_grad(), timer.phase("forwards"):
        want = spark.forward(params, cfg, tokens, modality).float() @ params["head"].float()
        got = (rwkv7.forward(fparams, fcfg, input_ids=torch.tensor([ids], device=dev)).float()
               @ fparams["head"].float())
        torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    V = cfg.semantic_vocab_size
    err = float((got[..., :V] - want).abs().max()) / float(want.abs().max())
    tail = float(got[..., V:].abs().max())
    src, dst = os.path.join(work, "flat.pth"), os.path.join(work, "flat_bf16.pth")
    with timer.phase("cast_fp32_to_bf16"):
        torch.save({k: torch.from_numpy(v) for k, v in flat.items()}, src)
        n_cast = rwkv7_ckpt.cast_fp32_to_bf16(src, dst)
    gb = (os.path.getsize(src) / 1e9, os.path.getsize(dst) / 1e9)
    r = {"positions": len(ids), "vocab": fcfg.vocab_size, "rel_err": err, "tail_max": tail,
         "launches": launches, "tensors": len(flat), "cast": n_cast, "gb_fp32_bf16": gb,
         "timer": timer.summary()}
    print(f"export: spark_to_flat of the trained {TASK_C} x {TASK_L} model: {len(flat)} tensors, "
          f"vocabulary {fcfg.vocab_size}; the flat model's logits on {len(ids)} positions of "
          f"{key} vs the Spark model's semantic logits: {err:.3e} of the largest (limit "
          f"{EXPORT_TOL}), beyond the semantic ids {tail}; launches {launches}; "
          f"cast_fp32_to_bf16: {n_cast} tensors cast, {gb[0]:.2f} -> {gb[1]:.2f} GB; "
          f"{r['timer']} on {card}")
    check(got.shape[1] == want.shape[1] == len(ids), "export: positions differ")
    check(err <= EXPORT_TOL and tail == 0.0, f"export: logits {err:.3e}, tail {tail}")
    check(n_cast == len(flat), f"export: {n_cast} of {len(flat)} tensors cast")
    del fparams, flat
    torch.cuda.empty_cache()
    return r


def corpus_phases(dev, card: str, run) -> dict:
    """Phases 35-38 in one temporary directory (the shards, the model
    directory, the rows, the run), removed at the end; `run(phase, *args)`
    keeps each phase's seconds."""
    with tempfile.TemporaryDirectory() as work:
        corpus = run(phase_corpus, dev, card, work)
        extracted = run(phase_extract, dev, card, work, corpus["shard_paths"])
        trained = run(phase_train_wds, dev, card, work, corpus["shard_paths"], extracted)
        exported = run(phase_export, dev, card, work, trained, extracted)
    corpus.pop("shard_paths")
    for key in ("codec_dir", "spark_tokens"):
        extracted.pop(key)
    for key in ("params", "cfg"):
        trained.pop(key)
    torch.cuda.empty_cache()
    return {"corpus": corpus, "extract": extracted, "train": trained, "export": exported}


def corpus_of_tree(what: str = "raw audio") -> dict:
    """Phases 35-38 alone with whichever rwkvtts_torch is imported, TF32
    off; prints their numbers and each phase's seconds as one JSON line."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    seconds = {}

    def run(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
        return out

    out = corpus_phases(dev, card, run)
    print(f"{what}: " + json.dumps({**out, "seconds": seconds}))
    return out


# ---------------------------------------------------------------------------
# 39-42. Quantized decode (int8 / int4 trees, bf16 ranking, the quality
# probe), the non-causal flow estimator
# ---------------------------------------------------------------------------

# quant small: a Spark-like RWKV-7 at hidden 256 x 2, f32, B rows, 4 chained
# decode steps; the samplers at (8, 8193) logits
QUANT_C, QUANT_L, QUANT_B, QUANT_STEPS = 256, 2, 4, 4
# the quality probe: its widths (Spark 0.4B, Cosy 1.5B), depth and greedy
# steps a mode (the JAX script runs 256)
QQ_HIDDEN, QQ_WIDE, QQ_LAYERS, QQ_STEPS = 1024, 2048, 24, 16
# the non-causal estimator's frames and the CFM solve's Euler steps
FLOW_NC_T, FLOW_NC_STEPS = 64, 10
# the interactive console's synthesize cap (random weights draw no EOS)
CLI_NEW = 64
# the remat policies phase 10 runs beside its default full replay, and the
# timed steps of each run (after one warm-up)
REMAT_RUNS, REMAT_TIMED = ("wkv", "dots"), 3


def phase_quant_small(dev) -> dict:
    """_quantize_int4's bytes and scales on the card = the CPU's; the model
    decode step on int8-unfused, int8-fused and int4 trees, card vs CPU (f32,
    TF32 off, 1e-4, 4 chained in-place steps, kernel 7 L a step);
    sample / ras_sample with rank_bf16 card vs CPU on one set of noise; the
    new refusals raise."""
    import numpy as np

    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import sampling
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving import launch

    C, L, Bn = QUANT_C, QUANT_L, QUANT_B
    g = torch.Generator().manual_seed(41)
    w = torch.randn(L, C, 3 * C + 160, generator=g).to(torch.bfloat16)
    q_c, q_g = rwkv7._quantize_int4(w), rwkv7._quantize_int4(w.to(dev))
    same_pack = all(torch.equal(q_c[k], q_g[k].cpu()) for k in ("q4", "s"))
    deq = max_abs(rwkv7._deq_int4(q_g, torch.float32).cpu(), rwkv7._deq_int4(q_c, torch.float32))
    n_bytes = int((q_c["q4"] != q_g["q4"].cpu()).sum())
    n_scales = int((q_c["s"] != q_g["s"].cpu()).sum())
    print(f"quant small: int4 pack of a {tuple(w.shape)} bf16 matrix on the card = the CPU's "
          f"(nibbles and bf16 scales): {same_pack} ({n_bytes} bytes, {n_scales} scales "
          f"differ); dequantized max|d| {deq:.1e}")
    check(same_pack and deq == 0.0, "quant small: the int4 pack differs on the card")

    cfg = rwkv7.RWKV7Config(vocab_size=0, hidden_size=C, num_layers=L, dtype=torch.float32,
                            decode_wkv_packed=True)
    params = rwkv7.init_params(torch.Generator().manual_seed(42), cfg)
    randomize(params, torch.Generator().manual_seed(43))
    state0 = {"att_x": torch.randn(L, Bn, C, generator=g),
              "wkv": 0.3 * torch.randn(L, Bn, C // 64, 64, 64, generator=g),
              "ffn_x": torch.randn(L, Bn, C, generator=g)}
    xs = [torch.randn(Bn, C, generator=g) for _ in range(QUANT_STEPS)]
    errs = {}
    for name, pack in (("int8 unfused", dict(quantize_int8=True, fuse_projections=False)),
                       ("int8 fused", dict(quantize_int8=True)), ("int4", dict(quantize_int4=True))):
        hs = {}
        for where in ("cpu", dev):
            p = rwkv7.tree_map(lambda t: t.to(where), params)
            views = rwkv7.layer_decode_views(rwkv7.pack_decode_params(p, cfg, **pack), cfg)
            st = rwkv7.pack_decode_state({k: v.to(where) for k, v in state0.items()}, cfg)
            sp.reset_launches()
            out = []
            for x in xs:
                h, st = rwkv7.decode_step(views, cfg, x.to(where), st)
                out.append(h.cpu())
            hs[str(where)] = (torch.stack(out), torch.stack([s["wkv"].cpu() for s in st]))
            n_step = sp.launches
        (h_c, s_c), (h_g, s_g) = hs["cpu"], hs[str(dev)]
        errs[name] = {"hidden_rel": rel(h_g, h_c), "state_rel": rel(s_g, s_c)}
        print(f"quant small: decode_step on the {name} tree, {C} x {L}, B={Bn}, f32, "
              f"{QUANT_STEPS} chained in-place steps, card vs CPU: hidden rel "
              f"{errs[name]['hidden_rel']:.2e}, WKV state rel {errs[name]['state_rel']:.2e} "
              f"(limit 1e-4); kernel 7 launches {n_step} ({L} a step)")
        check(errs[name]["hidden_rel"] <= 1e-4 and errs[name]["state_rel"] <= 1e-4,
              f"quant small: the {name} decode step disagrees with the CPU")
        check(n_step == L * QUANT_STEPS, f"quant small: kernel 7 launched {n_step} times")

    # rank_bf16: the same logits and noise on both sides (the candidates'
    # order is the stable bf16 sort's on either)
    V, k, K = 8193, 50, 25
    logits = 3.0 * torch.randn(8, V, generator=g)
    noise = sampling.gumbel((8, k), g)
    recent = torch.randint(0, V, (8, 10), generator=g)
    recent[:4] = torch.topk(logits[:4], 10).indices
    ras_noise = (sampling.gumbel((8, K), g), sampling.gumbel((8, V), g))
    toks = {}
    for where in ("cpu", dev):
        lg = logits.to(where)
        toks[str(where)] = (
            sampling.sample(lg, temperature=0.8, top_k=k, top_p=0.95, rank_bf16=True,
                            noise=noise.to(where)).cpu(),
            sampling.ras_sample(lg, recent.to(where), top_p=0.8, top_k=K, rank_bf16=True,
                                noise=tuple(n.to(where) for n in ras_noise)).cpu())
    same = [torch.equal(a, b) for a, b in zip(toks["cpu"], toks[str(dev)])]
    print(f"quant small: sample / ras_sample with rank_bf16 on (8, {V}) logits, card = CPU "
          f"given the same noise: {same}")
    check(all(same), "quant small: bf16-ranked draws differ on the card")

    refused = []
    for what, fn in (
            ("rank_bf16 at top-k 0", lambda: sampling.sample(logits, top_k=0, rank_bf16=True,
                                                             noise=torch.zeros(8, V))),
            ("int8 with int4", lambda: rwkv7.pack_decode_params(params, cfg, quantize_int8=True,
                                                                quantize_int4=True)),
            ("int4 unfused", lambda: rwkv7.pack_decode_params(params, cfg, quantize_int4=True,
                                                              fuse_projections=False)),
            ("a quantize flag on the B=1 kernel route",
             lambda: CosyPipeline(cosy.default_config(hidden_size=128, num_layers=1),
                                  cosy.init_params(torch.Generator().manual_seed(0),
                                                   cosy.default_config(128, 1)),
                                  None, quantize_int8=True, decode_megakernel=True,
                                  device=dev)),
            ("--mega with --int4", lambda: launch.main(["--ckpt", "unused", "--mega",
                                                        "--int4"]))):
        try:
            fn()
        except (ValueError, SystemExit):
            refused.append(what)
    print(f"quant small: refused: {refused}")
    check(len(refused) == 5, f"quant small: only {refused} were refused")
    return {"int4_pack_equal": same_pack, "decode_step": errs, "rank_bf16_equal": same}


def decode_step_times(params, cfg, dev, reps: int = 20) -> dict:
    """ms a model decode step (B = 8, the in-place f32 carry) on the bf16
    fused, int8 and int4 trees of `params` (bf16 matrices), by CUDA events
    over `reps` steps, and of the dequantization alone (every q8 / q4
    matrix of the tree turned into its bf16 weight once, as a step does)."""
    import dataclasses

    from rwkvtts_torch.models import rwkv7

    bb = dataclasses.replace(cfg.backbone, decode_wkv_packed=True)
    out = {}
    for name, pack in (("bf16", {}), ("int8", dict(quantize_int8=True)),
                       ("int4", dict(quantize_int4=True))):
        views = rwkv7.layer_decode_views(rwkv7.pack_decode_params(params, bb, **pack), bb)
        with torch.inference_mode():
            st = rwkv7.pack_decode_state(rwkv7.init_model_state(bb, 8, device=dev), bb)
            x = torch.randn(8, bb.hidden_size, device=dev, dtype=bb.dtype)
            step_ms = cuda_ms(lambda: rwkv7.decode_step(views, bb, x, st), reps)
            mats = [(bp[part], n) for bp in views["blocks"] for part in ("att", "ffn")
                    for n in ("fused_a", "fused_b", "output", "key", "value")
                    if f"{n}_q8" in bp[part] or f"{n}_q4" in bp[part]]
            deq_ms = (cuda_ms(lambda: [rwkv7._qmat(t, n, bb.dtype) for t, n in mats], 5)
                      if mats else 0.0)
        out[name] = {"step_ms": step_ms, "dequant_ms": deq_ms, "matrices": len(mats)}
        del views, st
    return out


def phase_cosy_quant_serve(dev, card: str, bf16_run: dict) -> dict:
    """The slice's path: the 1.5B pairing (phase 23's random Cosy LM 2048 x
    24 and codecs, the same seeds) through launch.cosy_pipeline with --int8
    and with --int4 (the fused pair, output and FFN as int8 / int4 on the
    rwkv7.decode_step route), CosyTTSService (8 slots, chunk 16, RAS 25 /
    0.8, hop 50, at most SERVE_COSY_SHORT tokens): 3 streams at once, two
    with 6 s prompt wavs and one through a stored voice; TTFA, pool ms a
    step, LM ms a token, 24 kernel-7 launches a pool step and 24 kernel-2
    an admission, every wav finite with 960 samples a token; beside phase
    23's bf16 numbers; then the model decode step's ms on the bf16, int8
    and int4 trees at B = 8 and the dequantization's share."""
    import collections
    import threading

    import numpy as np

    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import flow, hift
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.infer.voices import CosyVoiceLibrary
    from rwkvtts_torch.models import cosy, rwkv7
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving import launch
    from rwkvtts_torch.serving import service as svc

    L = COSY_L
    t0 = time.perf_counter()
    cfg = cosy.default_config(hidden_size=COSY_C, num_layers=L)
    g = torch.Generator(device=dev).manual_seed(0)
    params = cosy.init_params(g, cfg)
    randomize(params, g)
    gen_dev = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    fcfg, hcfg = flow.FlowConfig(sfm=True), hift.HiFTConfig()
    s3cfg, ccfg = s3.S3TokenizerConfig(), cp.CampplusConfig()
    codecs = dict(flow_cfg=fcfg, flow_params=flow.init_params(gen_dev(1), fcfg), hift_cfg=hcfg,
                  hift_params=hift.init_params(gen_dev(2), hcfg), s3_cfg=s3cfg,
                  s3_params=s3.init_params(gen_dev(3), s3cfg), campplus_cfg=ccfg,
                  campplus_params=cp.init_params(gen_dev(4), ccfg))
    clips = [prompt_clip(ZS_PROMPT_S, seed=10 + i) for i in range(2)]
    text = "The quick brown fox jumped over the lazy dog near the river."
    print(f"cosy quant serve: Cosy {COSY_C} x {L} and codecs (phase 23's seeds) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for mode in ("int8", "int4"):
        t0 = time.perf_counter()
        pipe = launch.cosy_pipeline(cfg, params, dev, int8=mode == "int8", int4=mode == "int4",
                                    **codecs)
        torch.cuda.synchronize()
        att = pipe.lm_params["blocks"]["att"]
        key = "fused_a_q8" if mode == "int8" else "fused_a_q4"
        check(pipe.lm_mega is None and key in att and "fused_a" not in att,
              f"cosy quant serve: --{mode} did not pack the {key} tree")
        up = pipe.flow_cfg.token_mel_ratio * pipe.hift_cfg.total_upsample
        with tempfile.TemporaryDirectory() as vdir:
            voices = CosyVoiceLibrary(vdir)
            voices.register_from_wav(pipe, "v0", clips[0])
            tts = svc.CosyTTSService(pipe, voices=voices, n_slots=SERVE_COSY_STREAMS,
                                     chunk=SERVE_COSY_CHUNK, max_new_tokens=SERVE_COSY_SHORT,
                                     top_k=25, top_p=0.8, warmup=True, warmup_widths=[128, 256])
            b = tts.hub.batcher
            rec = {"steps": [], "tokens": collections.Counter(), "admit": 0}
            step, process, prefill = b.step, b._process, b._prefill

            def timed_step():
                t = time.perf_counter()
                events = step()
                if b._pending is not None or events:
                    rec["steps"].append(time.perf_counter() - t)
                return events

            def counted_process(toks, owners):
                events = process(toks, owners)
                for rid, new, _ in events:
                    rec["tokens"][rid] += len(new)
                return events

            def counted_prefill(batch):
                rec["admit"] += 1
                return prefill(batch)

            b.step, b._process, b._prefill = timed_step, counted_process, counted_prefill
            reqs = [svc.TTSRequest(text=text, prompt_wav=clips[0], seed=0),
                    svc.TTSRequest(text=text, prompt_wav=clips[1], seed=1),
                    svc.TTSRequest(text=text, speaker="v0", seed=2)]
            got = [None] * len(reqs)

            def run(i):
                t, chunks, first = time.perf_counter(), [], None
                for c in tts.stream(reqs[i], hop_tokens=SERVE_COSY_HOP, timeout=600):
                    first = first or time.perf_counter() - t
                    chunks.append(c)
                got[i] = (first, np.concatenate(chunks), time.perf_counter() - t)

            torch.cuda.synchronize()
            sp.reset_launches()
            wkv7_cuda.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            try:
                t1 = time.perf_counter()
                threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t1
            finally:
                tts.close()
        check(all(x is not None for x in got), "cosy quant serve: a stream did not finish")
        samples = sorted(len(w) for _, w, _ in got)
        tokens = sorted(rec["tokens"].values())
        n_steps = SERVE_COSY_CHUNK * len(rec["steps"])
        launches = {"wkv7_step": sp.launches, "wkv7_fwd": wkv7_cuda.launches["wkv7_fwd"]}
        finite = all(bool(np.isfinite(w).all()) for _, w, _ in got)
        ttfa = sorted(1e3 * f for f, _, _ in got)
        step_ms = 1e3 * sum(rec["steps"]) / max(n_steps, 1)
        out[mode] = {"ttfa_ms": ttfa, "wall_s": wall, "tokens": tokens, "samples": samples,
                     "pool_steps": n_steps, "admissions": rec["admit"],
                     "pool_ms_per_step": step_ms, "lm_ms_a_token": step_ms,
                     "launches": launches, "finite": finite,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "setup_s": t1 - t0}
        print(f"cosy quant serve: --{mode}: 3 streams (2 prompt wavs, 1 stored voice) in "
              f"{wall:.2f} s: TTFA {[round(x, 1) for x in ttfa]} ms, tokens {tokens}, "
              f"samples {samples}; pool {step_ms:.3f} ms a step = LM ms a token of a stream "
              f"(over {n_steps} steps, {rec['admit']} admissions); launches {launches}; "
              f"peak memory {out[mode]['peak_gib']:.2f} GiB on {card}")
        check(finite and samples == sorted(n * up for n in tokens),
              f"cosy quant serve: --{mode} wavs {samples} for tokens {tokens} ({up} a token)")
        check(n_steps > 0 and launches["wkv7_step"] == L * n_steps,
              f"cosy quant serve: --{mode}: kernel 7 {launches['wkv7_step']} over {n_steps} "
              f"pool steps, want {L} a step")
        check(rec["admit"] > 0 and launches["wkv7_fwd"] == L * rec["admit"],
              f"cosy quant serve: --{mode}: kernel 2 {launches['wkv7_fwd']} over "
              f"{rec['admit']} admissions, want {L} an admission")
        del pipe, tts, voices
        torch.cuda.empty_cache()
    if bf16_run:
        print(f"cosy quant serve: phase 23's bf16 pool on its own traffic: solo "
              f"{bf16_run['solo_pool_ms_per_step']:.3f} ms a step, 8 streams "
              f"{bf16_run['pool_ms_per_step']:.3f} ms a step, stored-voice TTFA p50 "
              f"{bf16_run['pooled_stored']['ttfa_ms_p50']:.1f} ms")
        out["bf16_phase23"] = {k: bf16_run[k] for k in ("solo_pool_ms_per_step",
                                                        "pool_ms_per_step")}
    bf16 = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t, params)
    del params
    out["decode_step"] = decode_step_times(bf16, cfg, dev)
    print(f"cosy quant serve: model decode step at {COSY_C} x {L}, B = 8, by tree: "
          f"{ {k: round(v['step_ms'], 4) for k, v in out['decode_step'].items()} } ms, the "
          f"dequantization alone "
          f"{ {k: round(v['dequant_ms'], 4) for k, v in out['decode_step'].items()} } ms "
          f"(CUDA events) on {card}")
    del bf16
    torch.cuda.empty_cache()
    return out


def spark_int4_request(ckpt: str, card: str) -> dict:
    """The Spark launcher with --int4 on a checkpoint (its HTTP serve
    stubbed): the service its main builds over the int4 tree answers one
    request of 64 tokens; kernel 7 L a step."""
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving import http_server, launch
    from rwkvtts_torch.serving import service as svc

    box, serve = {}, http_server.serve
    http_server.serve = lambda tts, *a, **k: box.update(tts=tts)
    try:
        t0 = time.perf_counter()
        launch.main(["--ckpt", ckpt, "--int4", "--n-slots", "8", "--no-warmup"])
    finally:
        http_server.serve = serve
    tts = box["tts"]
    got = []
    finish = tts._finish
    tts._finish = lambda toks, g: (got.append(len(toks)), finish(toks, g))[1]
    try:
        check("fused_a_q4" in tts.pipeline.params["blocks"]["att"],
              "serve main: --int4 did not pack the int4 tree")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sp.reset_launches()
        ans = tts.synthesize(svc.TTSRequest(text="an int4 request", global_tokens=list(range(32)),
                                            max_new_tokens=64), timeout=600)
        wall = time.perf_counter() - t1
    finally:
        tts.close()
    steps = sp.launches // SERVE_LAYERS
    print(f"serve main: launch --int4: booted in {t1 - t0:.1f} s, one request {got} tokens "
          f"in {wall:.3f} s ({1e3 * wall / max(steps, 1):.2f} ms a pool step), kernel 7 "
          f"{sp.launches} launches, error {ans.error} on {card}")
    check(ans.error is None and got and got[0] > 0 and sp.launches % SERVE_LAYERS == 0
          and steps >= got[0], f"serve main: the --int4 request {got}, {sp.launches}")
    return {"tokens": got[0], "wall_s": wall, "wkv7_step": sp.launches}


def phase_quant_quality(dev, card: str) -> dict:
    """rwkvtts_torch.eval.quant_quality at Spark 1024 x 24 for int8,
    int4-g64, state-bf16 and int8+state-bf16 (B = 8) and the B=64 kernel
    (kernel 1, 194 launches a token), and at 2048 x 24 for int8 and
    int4-g64, QQ_STEPS greedy steps each, with the bf16-unfused control at
    both widths (the floor rounding alone sets); every JSON line printed;
    gated only on each agreement finite in [0, 1] and kernel 1's
    launches."""
    from rwkvtts_torch.eval import quant_quality as qq
    from rwkvtts_torch.ops import decode_mega_b64 as dmb

    L, recs = QQ_LAYERS, []
    t0 = time.perf_counter()
    recs += qq.measure(["bf16-unfused", "int8", "int4-g64", "state-bf16", "int8+state-bf16"],
                       QQ_HIDDEN, L, QQ_STEPS, dev)
    dmb.reset_launches()
    recs += qq.measure(["mega-b64"], QQ_HIDDEN, L, QQ_STEPS, dev)
    mega_launches = dmb.launches
    recs += qq.measure(["bf16-unfused", "int8", "int4-g64"], QQ_WIDE, L, QQ_STEPS, dev)
    wall = time.perf_counter() - t0
    for r in recs:
        print("quant quality: " + json.dumps(r))
    per_token = mega_launches / (2 * QQ_STEPS)  # the rollout's and the teacher forcing's steps
    print(f"quant quality: kernel 1 launched {mega_launches} times in the B=64 mode, "
          f"{per_token:.0f} a token (8 L + 2 = {8 * L + 2}); {wall:.1f} s on {card}")
    ok = all(0.0 <= r[k] <= 1.0 for r in recs
             for k in ("teacher_forced_top1_agreement", "free_running_token_agreement"))
    check(ok, "quant quality: an agreement outside [0, 1]")
    check(per_token == 8 * L + 2, f"quant quality: kernel 1 {per_token} a token")
    return {"records": recs, "mega_launches": mega_launches, "wall_s": wall}


def phase_flow_noncausal(dev, card: str) -> dict:
    """The non-causal estimator (EstimatorConfig(causal=False) at
    FlowConfig()'s widths, random weights) on the card vs the CPU in f32
    with TF32 off (1e-4), B = 2, FLOW_NC_T frames, a masked tail; then one
    CFM solve of FLOW_NC_STEPS Euler steps with CFG on both (1e-4)."""
    import dataclasses

    from rwkvtts_torch.codecs import flow
    from rwkvtts_torch.models import rwkv7

    fcfg = flow.FlowConfig()
    ecfg = dataclasses.replace(fcfg.estimator, causal=False)
    p_c = flow.estimator_init(torch.Generator().manual_seed(44), ecfg)
    p_g = rwkv7.tree_map(lambda t: t.to(dev), p_c)
    g = torch.Generator().manual_seed(45)
    Bn, T, M = 2, FLOW_NC_T, fcfg.output_size
    x, mu, cond = (torch.randn(Bn, T, M, generator=g) for _ in range(3))
    spks = torch.randn(Bn, M, generator=g)
    mask = torch.ones(Bn, T)
    mask[1, T - 9:] = 0
    t = torch.tensor([0.3, 0.8])
    args = (x, mask, mu, t, spks, cond)
    with torch.inference_mode():
        v_c = flow.estimator_apply(p_c, ecfg, *args)
        t0 = time.perf_counter()
        v_g = flow.estimator_apply(p_g, ecfg, *(a.to(dev) for a in args)).cpu()
        est_ms = 1e3 * (time.perf_counter() - t0)
        z = torch.randn(Bn, T, M, generator=g)
        solve = (z, mu, mask, spks, cond)
        s_c = flow.cfm_solve(p_c, ecfg, fcfg.cfm, *solve, n_timesteps=FLOW_NC_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_g = flow.cfm_solve(p_g, ecfg, fcfg.cfm, *(a.to(dev) for a in solve),
                             n_timesteps=FLOW_NC_STEPS).cpu()
        solve_ms = 1e3 * (time.perf_counter() - t0)
    out = {"estimator_rel": rel(v_g, v_c), "solve_rel": rel(s_g, s_c), "estimator_ms": est_ms,
           "solve_ms": solve_ms, "finite": bool(torch.isfinite(s_g).all())}
    print(f"flow non-causal: the estimator at FlowConfig()'s widths, causal=False (GroupNorm(8) "
          f"blocks, padding-1 convolutions), B={Bn} x {T} frames, f32, TF32 off: card vs CPU rel "
          f"{out['estimator_rel']:.2e} (limit 1e-4), {est_ms:.1f} ms; a {FLOW_NC_STEPS}-step CFM "
          f"solve: rel {out['solve_rel']:.2e} (limit 1e-4), {solve_ms:.1f} ms on {card}")
    check(out["finite"] and out["estimator_rel"] <= 1e-4 and out["solve_rel"] <= 1e-4,
          "flow non-causal: the estimator or the solve disagrees with the CPU")
    return out


def interactive_session(pipe, card: str) -> dict:
    """rwkvtts_torch.serving.interactive_cli.repl on `pipe` with a scripted
    stdin (/voice design with the properties' defaults, one line of text,
    /quit), synthesize capped at CLI_NEW tokens: one finite wav written."""
    import functools
    import io
    import sys
    import types
    import wave

    import numpy as np

    from rwkvtts_torch.serving import interactive_cli

    capped = types.SimpleNamespace(design_voice=pipe.design_voice, codec=pipe.codec,
                                   synthesize=functools.partial(pipe.synthesize,
                                                                max_new_tokens=CLI_NEW))
    stdin = sys.stdin
    sys.stdin = io.StringIO("/voice design\n" + "\n" * 5 + "Hello from the console.\n/quit\n")
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            interactive_cli.repl(capped, d)
            wall = time.perf_counter() - t0
            names = sorted(os.listdir(d))
            samples = np.zeros(0, np.int16)
            if names:
                with wave.open(os.path.join(d, names[0])) as f:
                    samples = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    finally:
        sys.stdin = stdin
    hop = pipe.codec.cfg.latent_hop_length
    print(f"interactive cli: a scripted session (/voice design, one line, /quit) wrote {names}, "
          f"{samples.size} samples, in {wall:.2f} s on {card}")
    check(names == ["tts_0000.wav"] and samples.size > 0 and samples.size % hop == 0
          and np.abs(samples).max() > 0, "interactive cli: not one nonempty wav")
    return {"files": names, "samples": int(samples.size), "wall_s": wall}


def quant_of_tree(what: str = "quant") -> dict:
    """The parts this port's quantized-decode slice added, alone: phases
    39-42, the remat runs of phase 10 (through phase 10 itself), the --int4
    launcher request on its own checkpoint and the interactive session on a
    Spark 1024 x 24 pipeline with a random BiCodecConfig() codec; prints
    their numbers as one JSON line."""
    from rwkvtts_torch.codecs import bicodec
    from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer
    from rwkvtts_torch.convert import export_hf
    from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.utils import tokenizer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    seconds, out = {}, {}

    def run(phase, *args):
        t = time.perf_counter()
        res = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
        return res

    out["quant_small"] = run(phase_quant_small, dev)
    out["cosy_quant_serve"] = run(phase_cosy_quant_serve, dev, card, None)
    out["quant_quality"] = run(phase_quant_quality, dev, card)
    out["flow_noncausal"] = run(phase_flow_noncausal, dev, card)
    out["train_main"] = run(phase_train_main, dev, card)["remat"]
    cfg = spark.default_config(hidden_size=SERVE_HIDDEN, num_layers=SERVE_LAYERS)
    params = spark.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        export_hf.save_pretrained(params, cfg, d)
        out["spark_int4"] = run(spark_int4_request, os.path.join(d, "model.safetensors"), card)
    ccfg = wav_codec_config()
    codec = SparkAudioTokenizer(ccfg, bicodec.init_params(
        torch.Generator(device=dev).manual_seed(0), ccfg))
    lm = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t, params)
    pipe = SparkPipeline(cfg, lm, tokenizer.get_world_tokenizer(n_spct=48), audio_tokenizer=codec)
    out["interactive_cli"] = run(interactive_session, pipe, card)
    print(f"{what}: " + json.dumps({**out, "seconds": seconds}))
    return out



# ---------------------------------------------------------------------------
# 43-46. Several ranks: the mesh step over NCCL, gloo ranks sharing the card,
# the train CLI under torchrun, the dp slot pool
# ---------------------------------------------------------------------------

DIST_C, DIST_L = 256, 2  # the small mesh steps' model
DIST_B, DIST_T = 8, 256  # their batch; the sp batch packs 8 half rows into 4 lines
DIST_TIMEOUT = 300  # seconds a torchrun may take
DIST_WARM, DIST_TIMED = 1, 2  # phase 45's steps
# phase 46's groups, tokens a request and requests (more than the slots: the
# queued ones take the slots that the first chunk frees, in every group)
POOL_DP, POOL_NEW, POOL_REQUESTS = 2, 32, 144
ROUTE_SHAPE = (2, 512, 16, 4)  # the sp route's check: B, T, H, spans


def torchrun(n: int, args, timeout: int = DIST_TIMEOUT) -> str:
    """`python -m torch.distributed.run --standalone --nproc-per-node n
    ARGS` from the repository root, in a session of its own: killed whole
    at `timeout`; a rank's failure (torchrun's non-zero exit) fails the
    phase. Returns its output."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", *args]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    check(p.returncode == 0, f"torchrun {' '.join(args[:3])} ... exited {p.returncode}:\n"
          + out[-4000:])
    return out


def dist_model(dtype, spans: int = 1):
    """Spark DIST_C x DIST_L, dropout 0, its zero matrices randomised; the
    fused prep without spans, the span route with them; f32 on the host."""
    from rwkvtts_torch.models import spark

    cfg = spark.default_config(hidden_size=DIST_C, num_layers=DIST_L, dtype=dtype, dropout=0.0,
                               wkv_spans=spans, wkv_fuse_prep=spans == 1)
    params = spark.init_params(torch.Generator().manual_seed(19), cfg)
    randomize(params, torch.Generator().manual_seed(20))
    return cfg, params


def dist_batch(seed: int, packed: bool = False) -> dict:
    """DIST_B rows of DIST_T positions; packed, 2 * DIST_B rows of half as
    many packed two a line (a reset at DIST_T / 2, the sp rank and span
    boundary)."""
    import functools

    from rwkvtts_torch.data import spark_collator as sc
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    collate = functools.partial(sc.collate_plain, tokenizer=get_world_tokenizer(), eos_id=8192,
                                pad_to=DIST_T, packed=packed)
    if not packed:
        return collate(synthetic_rows(seed, DIST_B, DIST_T))
    import numpy as np

    rows = synthetic_rows(seed, DIST_B, DIST_T // 2)
    lines = [collate(rows[i:i + 2]) for i in range(0, DIST_B, 2)]
    return {k: np.concatenate([line[k] for line in lines]) for k in lines[0]}


def dist_spec(dev, cfg, params, batch, mesh: dict, opt=None, **kw) -> dict:
    from rwkvtts_torch.train import optimizer as opt_lib

    flat = {p: t.detach().cpu().numpy() for p, t in opt_lib.flatten(params).items()}
    return dict(cfg=cfg, task="spark", params=flat, batch=batch, mesh=mesh, device=str(dev),
                optimizer=opt or {}, timeout=120, **kw)


def one_process_steps(cfg, params, batch, dev, steps: int = 1, opt=None):
    """The one-process train step (on ``mesh.Local``) on the card from the same weights
    (AdamW with `opt`, by default the trainer's: warm-up 1000 steps, so the
    first step's LR is 0, as in tests/test_parallel.py: Adam's first update
    is lr times the gradient's sign, which rounding flips where a gradient
    is nearly 0, so the moments carry the gradient check)."""
    from rwkvtts_torch.models import rwkv7
    from rwkvtts_torch.parallel import train_step as ts
    from rwkvtts_torch.train import optimizer as opt_lib

    p = rwkv7.tree_map(lambda t: t.to(dev).clone(), params)
    opt = opt_lib.AdamW(p, **(opt or {}))
    state = ts.init_train_state(p, opt)
    step = ts.make_train_step(cfg, opt)
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, b, None)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def mesh_vs_one(what: str, res: dict, state, metrics) -> dict:
    """A mesh run's loss (1e-4), grad norm (1e-3), post-step parameters
    (rtol 2e-4, atol 2e-6, leaf by leaf) and first moments (= 0.1 x the
    reduced gradient; 1e-4 of each leaf's largest) against the
    single-process step."""
    from rwkvtts_torch.train import optimizer as opt_lib

    m, w = res["metrics"][-1], metrics[-1]
    el = abs(m["loss"] - w["loss"]) / abs(w["loss"])
    eg = abs(m["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
    worst = 0.0
    for p, t in opt_lib.flatten(state.params).items():
        got, want = res["params"][p].float(), t.detach().cpu().float()
        excess = ((got - want).abs() - 2e-4 * want.abs()).max().item()
        worst = max(worst, excess)
    mu = max(rel(res["opt_state"]["mu"][p], t.cpu()) for p, t in state.opt_state["mu"].items())
    out = {"loss": m["loss"], "one_process_loss": w["loss"], "loss_rel": el, "grad_norm_rel": eg,
           "param_excess_over_rtol": worst, "mu_rel": mu, "skipped": m["skipped"],
           "tokens": m["tokens"], "ranks": res["ranks"]}
    print(f"{what}: loss {m['loss']:.6f} vs {w['loss']:.6f} (one process) (rel {el:.2e}, limit 1e-4), grad "
          f"norm rel {eg:.2e} (limit 1e-3), parameters' largest |diff| - 2e-4 |one process| "
          f"{worst:.2e} (limit 2e-6), first moments' largest rel {mu:.2e} (limit 1e-4); "
          f"collectives a rank {[r['collectives'] for r in res['ranks']]}, ms a step "
          f"{res['ranks'][0]['ms']}")
    check(el <= 1e-4 and eg <= 1e-3 and worst <= 2e-6 and mu <= 1e-4 and m["skipped"] == 0
          and m["tokens"] == w["tokens"], f"{what}: the mesh step disagrees with the one-process step")
    return out


def phase_dist_nccl(dev, card: str) -> dict:
    """One torchrun rank over NCCL: the mesh step (dp = fsdp = tp = 1, so
    every gather and reduce-scatter is issued on groups of one) of Spark
    DIST_C x DIST_L in bf16, two steps, = the single-process step bit for
    bit (parameters, moments, loss and norm), deterministic algorithms on
    both sides."""
    import pickle

    from rwkvtts_torch.train import optimizer as opt_lib

    cfg, params = dist_model(torch.bfloat16)
    batch = dist_batch(21)
    with tempfile.TemporaryDirectory() as tmp:
        spec = dist_spec(dev, cfg, params, batch, {"dp": 1}, opt=dict(warmup_steps=0),
                         backend="nccl", steps=2, deterministic=True, time_collectives=True)
        with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
            pickle.dump(spec, f)
        torchrun(1, ["-m", "rwkvtts_torch.parallel.dryrun", os.path.join(tmp, "spec.pkl"),
                     os.path.join(tmp, "out")])
        res = torch.load(os.path.join(tmp, "out", "result.pt"), weights_only=False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, metrics = one_process_steps(cfg, params, batch, dev, 2, opt=dict(warmup_steps=0))
    finally:
        torch.use_deterministic_algorithms(False)
    same_metrics = [{k: m[k] for k in ("loss", "grad_norm", "tokens", "skipped")}
                    for m in res["metrics"]] == [
        {k: m[k] for k in ("loss", "grad_norm", "tokens", "skipped")} for m in metrics]
    differ = [p for p, t in opt_lib.flatten(state.params).items()
              if not torch.equal(res["params"][p], t.cpu())]
    differ += [f"{k}/{p}" for k in ("mu", "nu") for p, t in state.opt_state[k].items()
               if not torch.equal(res["opt_state"][k][p], t.cpu())]
    rank = res["ranks"][0]
    print(f"dist nccl: 1 rank, Spark {DIST_C} x {DIST_L} bf16, B={DIST_B} x {DIST_T}, 2 steps: "
          f"losses {[m['loss'] for m in res['metrics']]} vs {[m['loss'] for m in metrics]}; "
          f"{rank['collectives']} collectives; leaves that differ from the one-process step: "
          f"{differ[:8]} ({len(differ)}); launches {rank['launches']} on {card}")
    check(same_metrics and not differ, "dist nccl: the one-rank mesh step is not the one-process "
          "step (mesh.Local) bit for bit")
    check(rank["collectives"] > 0, "dist nccl: no collective issued")
    return {"losses": [m["loss"] for m in res["metrics"]], "collectives": rank["collectives"],
            "launches": rank["launches"], "bit_identical": True}


def route_check(dev, card: str) -> dict:
    """ops/wkv7.wkv7_spans on the card (kernels 2 and 3, two runs a span,
    the spans in the batch) against the plain wkv7_chunked_sp on the card,
    f32 at ROUTE_SHAPE with resets, random decays and w_raw = -0.5
    everywhere: y, the final state and every input gradient within 1e-4 of
    the largest; 2 kernel-2 and 2 kernel-3 launches a call (wkv_inputs'
    entry state and resets)."""
    from rwkvtts_torch.ops import wkv7 as wkv7_ops
    from rwkvtts_torch.ops import wkv7_cuda

    Bn, T, H, spans = ROUTE_SHAPE
    g = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for name in ("random", "w_raw=-0.5"):
        seq, state, resets = wkv_inputs(g, Bn, T, H, torch.float32)
        if name != "random":
            seq[1] = torch.full_like(seq[1], -0.5)
        dy = torch.randn(Bn, T, H, 64, generator=g, device=dev)
        ds = torch.randn(Bn, H, 64, 64, generator=g, device=dev)
        grads = {}
        for kind, fn in (("kernels", lambda *a: wkv7_ops.wkv7_spans(*a, spans=spans)),
                         ("plain", lambda *a: wkv7_ops.wkv7_chunked_sp(*a, spans=spans))):
            leaves = [t.clone().requires_grad_() for t in (*seq, state)]
            wkv7_cuda.reset_launches()
            y, s = fn(*leaves, resets)
            gr = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
            torch.cuda.synchronize()
            grads[kind] = (y.detach(), s.detach(), *gr, dict(wkv7_cuda.launches))
        errs = [rel(a, b) for a, b in zip(grads["kernels"][:-1], grads["plain"][:-1])]
        launches = grads["kernels"][-1]
        out[name] = {"rel": max(errs), "launches": launches}
        print(f"dist small: sp route (B, T, H) = ({Bn}, {T}, {H}), {spans} spans, f32, {name}: "
              f"y, state and 7 gradients vs wkv7_chunked_sp, largest rel {max(errs):.2e} "
              f"(limit 1e-4); launches {launches}")
        check(max(errs) <= 1e-4, f"dist small: the sp route disagrees with its plain version "
              f"({name}): {errs}")
        check(launches["wkv7_fwd"] == 2 and launches["wkv7_bwd"] == 2,
              f"dist small: route launches {launches}")
    return out


def phase_dist_small(dev, card: str) -> dict:
    """4 gloo ranks on the one card (spawned), Spark DIST_C x DIST_L f32:
    dp=2 x fsdp=2 on DIST_B x DIST_T and dp=2 x sp=2 (wkv_spans 4) on the
    packed batch, each against the single-process step on the card; the
    fsdp run's checkpoint restored in this process = its gathered state;
    the sp route against its plain version."""
    from rwkvtts_torch.parallel import dryrun
    from rwkvtts_torch.parallel import train_step as ts
    from rwkvtts_torch.train import checkpoint as ckpt_lib
    from rwkvtts_torch.train import optimizer as opt_lib

    out = {"route": route_check(dev, card)}
    cfg, params = dist_model(torch.float32)
    cfg_sp, _ = dist_model(torch.float32, spans=4)
    batch, packed = dist_batch(22), dist_batch(24, packed=True)
    check(packed["tokens"].shape == (4, DIST_T) and packed["resets"][:, DIST_T // 2].all(),
          f"dist small: the packed batch {packed['tokens'].shape}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        specs = [(dist_spec(dev, cfg, params, batch, {"dp": 2, "fsdp": 2}, backend="gloo",
                            init_method=f"file://{tmp}/store_fsdp", save=ckpt,
                            time_collectives=True), os.path.join(tmp, "fsdp")),
                 (dist_spec(dev, cfg_sp, params, packed, {"dp": 2, "sp": 2}, backend="gloo",
                            init_method=f"file://{tmp}/store_sp", time_collectives=True),
                  os.path.join(tmp, "sp"))]
        t = time.perf_counter()
        fsdp, sp = dryrun.spawn(4, specs, tmp)
        wall = time.perf_counter() - t
        like = ts.init_train_state(params, opt_lib.AdamW(params))
        restored, _ = ckpt_lib.restore(ckpt, like)
    same = all(torch.equal(t, fsdp["params"][p]) for p, t in
               opt_lib.flatten(restored.params).items()) and all(
        torch.equal(t, fsdp["opt_state"][k][p]) for k in ("mu", "nu")
        for p, t in restored.opt_state[k].items())
    print(f"dist small: 4 gloo ranks on one card (not a multi-GPU number), both meshes "
          f"{wall:.1f} s; the fsdp checkpoint restored in one process = the gathered state: "
          f"{same}")
    check(same and restored.step == 1, "dist small: the fsdp checkpoint does not restore whole")
    out["fsdp"] = mesh_vs_one("dist small: dp=2 x fsdp=2", fsdp,
                                *one_process_steps(cfg, params, batch, dev))
    out["sp"] = mesh_vs_one("dist small: dp=2 x sp=2, wkv_spans 4", sp,
                              *one_process_steps(cfg_sp, params, packed, dev))
    for key in ("fsdp", "sp"):
        out[key]["ranks"] = [{k: r[k] for k in ("launches", "ms", "collectives")}
                             for r in out[key]["ranks"]]
    return out


def dist_main_run(dev, card: str, tmp: str, data: str, mesh: str, Bn: int) -> dict:
    """train.cli under torchrun, 2 gloo ranks on the one card, Spark at
    TRAIN_H * 64 x TRAIN_LAYERS, DIST_WARM + DIST_TIMED + 1 steps of Bn x
    TRAIN_T (ms a step over the timed ones, as in phase 10); each rank's
    launches, seconds in collectives, peak memory."""
    out_dir = os.path.join(tmp, mesh.replace("=", ""))
    n = DIST_WARM + DIST_TIMED + 1  # the last step's end stamps the last timed one's log
    args = _cli_args(dev, data, os.path.join(out_dir, "run"), TRAIN_LAYERS,
                     ("--mesh", mesh, "--dist-backend", "gloo", "--max-rows", str(Bn * n)))
    args[args.index("--batch-size") + 1] = str(Bn)
    t = time.perf_counter()
    torchrun(2, ["-m", "rwkvtts_torch.parallel.dryrun", "--cli", out_dir, "--no-save", *args])
    wall = time.perf_counter() - t
    ranks = [json.load(open(os.path.join(out_dir, f"cli_rank{r}.json"))) for r in range(2)]
    with open(os.path.join(out_dir, "run", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs]
    check(len(recs) == n and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(8193)) <= 0.5 and sum(r["skipped"] for r in recs) == 0,
          f"dist main {mesh}: losses {losses}, skipped {[r['skipped'] for r in recs]}")
    # as in phase 10: log k's stamp marks the end of step k + 1
    stamps = [r["time"] for r in recs]
    step_s = (stamps[n - 2] - stamps[DIST_WARM - 1]) / DIST_TIMED
    per_step = [{k: v / n for k, v in r["launches"].items()} for r in ranks]
    coll = [r["collective_s"] / n for r in ranks]
    r = {"mesh": mesh, "B": Bn, "T": TRAIN_T, "losses": losses, "launches_a_step": per_step,
         "step_ms": 1e3 * step_s,
         "collective_ms_a_step": [1e3 * c for c in coll],
         "collectives_a_step": [x["collectives"] / n for x in ranks],
         "peak_gib": [(x["peak_bytes"] or 0) / 2**30 for x in ranks], "wall_s": wall,
         "shard_shapes": {p: ranks[0]["shapes"][p] for p in ("blocks/att/key", "head")}}
    print(f"dist main: train.cli --mesh {mesh}, 2 gloo ranks on one card (not a multi-GPU "
          f"number), Spark {TRAIN_H * 64} x {TRAIN_LAYERS} bf16, B={Bn} x {TRAIN_T} global: "
          f"losses {[round(x, 4) for x in losses]}, ms a step {r['step_ms']:.1f}, in collectives "
          f"{[round(c, 1) for c in r['collective_ms_a_step']]} ms a step a rank (synchronised "
          f"around each), peak {[round(p, 2) for p in r['peak_gib']]} GiB a rank, launches a "
          f"step a rank {per_step}, {wall:.1f} s of torchrun on {card}")
    return r


def phase_dist_main(dev, card: str) -> dict:
    """train.cli under torchrun with 2 gloo ranks on the one card at Spark
    1024 x 24: --mesh fsdp=2 at B = 8 x 2048 global (fused prep: kernels
    4 / 5 48 / 24 launches a step a rank) and --mesh sp=2 at 4 x 2048 (the
    span route, 1 span a rank: predicted kernels 2 / 3 96 / 48 a step a
    rank, two runs a span in the forward and again in the block's replay,
    two in the backward)."""
    L = TRAIN_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "rows.jsonl")
        with open(data, "w") as f:
            for row in synthetic_rows(31, TRAIN_B * (DIST_WARM + DIST_TIMED + 1), TRAIN_T):
                f.write(json.dumps(row) + "\n")
        fsdp = dist_main_run(dev, card, tmp, data, "fsdp=2", TRAIN_B)
        sp = dist_main_run(dev, card, tmp, data, "sp=2", TRAIN_B // 2)
    for r in fsdp["launches_a_step"]:
        check(r["wkv7_fused_fwd"] == 2 * L and r["wkv7_fused_bwd"] == L and r["wkv7_fwd"] == 0,
              f"dist main fsdp=2: launches a step {r}, want {2 * L} / {L} fused")
    for r in sp["launches_a_step"]:
        check(r["wkv7_fwd"] == 4 * L and r["wkv7_bwd"] == 2 * L and r["wkv7_fused_fwd"] == 0,
              f"dist main sp=2: launches a step {r}, want {4 * L} / {2 * L} of kernels 2 / 3")
    check(fsdp["shard_shapes"]["blocks/att/key"][1] * 2 == TRAIN_H * 64,
          f"dist main: fsdp shard {fsdp['shard_shapes']}")
    return {"fsdp2": fsdp, "sp2": sp}


def phase_dp_pool(dev, card: str) -> dict:
    """The Spark pool at 1024 x 24 (bf16 matrices, the decode-packed tree),
    96 slots, chunk SERVE_CHUNK, as POOL_DP groups on the one card against
    one group: POOL_REQUESTS requests of POOL_NEW tokens (those beyond the
    slots wait in the queue for the slots that finish), greedy and sampled (top-k
    50, top-p 0.95, a seed each), the same tokens; kernel 7 24 launches a
    step a group; ms a pool step of each."""
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.ops import wkv7_step_packed as sp
    from rwkvtts_torch.serving.continuous import ContinuousBatcher

    cfg = spark.default_config(hidden_size=SERVE_HIDDEN, num_layers=SERVE_LAYERS,
                               decode_wkv_packed=True)
    params = _bf16_matrices(spark.init_params(torch.Generator(device=dev).manual_seed(3), cfg))
    packed = rwkv7.pack_decode_params(params, cfg.backbone)
    prompts = serve_prompts(POOL_REQUESTS, 41)
    out = {}
    for mode, kw in (("greedy", dict(top_k=1)), ("sampled", dict(top_k=50, top_p=0.95))):
        toks, times = {}, {}
        for groups in (1, POOL_DP):
            cb = ContinuousBatcher(packed, cfg, n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK,
                                   devices=[dev] * groups if groups > 1 else None, **kw)
            cb.warmup()
            rids = {cb.add_request(pb, POOL_NEW, seed=i): i for i, (pb, _) in enumerate(prompts)}
            with torch.inference_mode():  # one full chunk, timed
                cb._admit()
                torch.cuda.synchronize()
                sp.reset_launches()
                t = time.perf_counter()
                cb._to_host(cb._chunk())
                torch.cuda.synchronize()
            times[groups] = 1e3 * (time.perf_counter() - t) / SERVE_CHUNK
            launches = sp.launches
            cb.reset()
            rids = {cb.add_request(pb, POOL_NEW, seed=i): i for i, (pb, _) in enumerate(prompts)}
            toks[groups] = {rids[r]: t for r, t in cb.drain().items()}
            check(len(toks[groups]) == POOL_REQUESTS,
                  f"dp pool: {len(toks[groups])} of {POOL_REQUESTS} requests answered")
            check(launches == SERVE_LAYERS * SERVE_CHUNK * groups,
                  f"dp pool: {launches} kernel-7 launches a chunk of {groups} groups, want "
                  f"{SERVE_LAYERS} a step a group")
            del cb
        same = toks[1] == toks[POOL_DP]
        n_tok = sum(len(t) for t in toks[1].values())
        out[mode] = {"same_tokens": same, "tokens": n_tok,
                     "ms_a_pool_step": {str(k): v for k, v in times.items()}}
        print(f"dp pool: Spark {SERVE_HIDDEN} x {SERVE_LAYERS} bf16, {SERVE_SLOTS} slots, "
              f"{POOL_REQUESTS} requests, {mode}: "
              f"{POOL_DP} groups on one card = 1 group: {same} ({n_tok} tokens); ms a pool "
              f"step {times} (groups on one card run one after the other: not a multi-GPU "
              f"number) on {card}")
        check(same, f"dp pool: {POOL_DP} groups' tokens differ from one group's ({mode})")
    out["launches_a_step_a_group"] = SERVE_LAYERS
    del params, packed
    torch.cuda.empty_cache()
    return out


def dist_of_tree(what: str = "dist") -> dict:
    """Phases 43-46 alone, with their checks."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from rwkvtts_torch import _build

    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out, seconds = {}, {}
    for phase in (phase_dist_nccl, phase_dist_small, phase_dist_main, phase_dp_pool):
        t = time.perf_counter()
        out[phase.__name__] = phase(dev, card)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
    print(f"{what}: " + json.dumps({**out, "seconds": seconds}))
    return out


def build_log(log: str) -> None:
    """Print ptxas's registers, shared memory and spills of every kernel,
    and fail if a chunked WKV7 kernel (forward, backward, fused pair)
    spills."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties for" in line:
            entry = line.split("'")[1] if "'" in line else line.split()[-1]
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print("build: " + line.strip())
        if "spill" in line and any(k in entry for k in ("wkv7_fwd", "wkv7_fused", "wkv7_bwd")):
            stores, loads = (int(x.split()[0]) for x in line.split(",")[1:3])
            check(stores == 0 and loads == 0, f"{entry} spills: {line.strip()}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    import concurrent.futures

    from rwkvtts_torch import _build
    from rwkvtts_torch.utils import native

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t_start = t0 = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        """phase(*args), its wall seconds kept under its name."""
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
        return out

    # the host C++ libraries (tar streamer, tokenizer trie) build with g++
    # while nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: [native.load(n) for n in HOST_LIBRARIES])
        _build.library()
        host.result()
    lib_path = _build.library_path()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build_seconds:.1f} s) -> {lib_path.name}; g++ of the host "
          f"libraries {native.build_seconds} s")
    build_log(lib_path.with_suffix(".log").read_text())
    seconds["build"] = round(time.perf_counter() - t0, 1)

    rows = {"wkv7_fwd": run(phase_wkv7, dev)}
    rows["decode_b64_step"], per_step = run(phase_decode, dev)
    run(phase_small, dev)
    main_run = run(phase_main, dev, card, per_step)
    rows["wkv7_bwd"], train_fwd = run(phase_wkv7_train, dev)
    rows["wkv7_fused_fwd"], rows["wkv7_fused_bwd"] = run(phase_wkv7_fused, dev)
    run(phase_train_small, dev)
    train_run = run(phase_train_main, dev, card)
    rows["decode_b1_step"], b1_per_step, b1_ms = run(phase_decode_b1, dev)
    run(phase_cosy_small, dev)
    cosy_run = run(phase_cosy_main, dev, card, b1_ms)
    rows["wkv7_step"] = run(phase_wkv7_step, dev)
    run(phase_serve_small, dev)
    serve_run = run(phase_serve_main, dev, card)
    run(phase_spark_wav_small, dev)
    wav_run = run(phase_spark_wav_main, dev, card, main_run)
    run(phase_cosy_zs_small, dev)
    zs_run = run(phase_cosy_zs_main, dev, card)
    b64_run = run(phase_cosy_b64, dev, card)
    run(phase_cosy_serve_small, dev)
    cs_run = run(phase_cosy_serve_main, dev, card)
    run(phase_xy_small, dev)
    xy_run = run(phase_xy_main, dev, card)
    asr_small = run(phase_asr_small, dev)
    asr_run = run(phase_asr_main, dev, card)
    tasks_small = run(phase_train_tasks_small, dev)
    tasks_run = run(phase_train_tasks_main, dev, card)
    long_run = run(phase_cosy_long, dev, card)
    mark_run = run(phase_long_train, dev, card)
    seed_run = run(phase_seed_tts, dev, card)
    rank_run = run(phase_ranking_demo, dev, card)
    greedy_run = run(phase_spark_generate, dev, card)
    raw_run = corpus_phases(dev, card, run)
    quant_small = run(phase_quant_small, dev)
    cq_run = run(phase_cosy_quant_serve, dev, card, cs_run)
    qq_run = run(phase_quant_quality, dev, card)
    flow_nc = run(phase_flow_noncausal, dev, card)
    nccl_run = run(phase_dist_nccl, dev, card)
    dist_small = run(phase_dist_small, dev, card)
    dist_run = run(phase_dist_main, dev, card)
    pool_run = run(phase_dp_pool, dev, card)

    rows["wkv7_fwd"]["launches"] = main_run["launches"]["wkv7_fwd"]
    rows["wkv7_fwd"]["train_forward"] = train_fwd  # its training-shape numbers, unfused path
    rows["decode_b64_step"]["launches"] = main_run["launches"]["decode_b64_step"]
    rows["decode_b64_step"]["launches_by_kernel"] = main_run["by_kernel"]
    rows["wkv7_bwd"]["launches"] = train_run["unfused"]["wkv7_bwd"]
    rows["wkv7_fused_fwd"]["launches"] = train_run["launches"]["wkv7_fused_fwd"]
    rows["wkv7_fused_bwd"]["launches"] = train_run["launches"]["wkv7_fused_bwd"]
    rows["wkv7_fwd"]["launches_cosy_main"] = cosy_run["launches"]["wkv7_fwd"]
    rows["decode_b1_step"]["launches"] = cosy_run["launches"]["decode_b1_step"]
    rows["decode_b1_step"]["launches_by_kernel"] = cosy_run["launches"]["by_kernel"]
    rows["decode_b1_step"]["launches_per_step"] = b1_per_step
    rows["wkv7_step"]["launches"] = serve_run["launches"]["wkv7_step"]
    rows["wkv7_step"]["decode_steps_serve_main"] = serve_run["decode_steps"]
    rows["wkv7_fwd"]["launches_serve_main"] = serve_run["launches"]["wkv7_fwd"]
    zs_launches = lambda k: {n: r["launches"][k] for n, r in zs_run["runs"].items()}
    rows["wkv7_fwd"]["launches_cosy_zs"] = zs_launches("wkv7_fwd")
    rows["wkv7_fwd"]["launches_cosy_b64"] = b64_run["launches"]["wkv7_fwd"]
    rows["decode_b64_step"]["cosy_b64_2048x24"] = {
        k: b64_run[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    rows["decode_b64_step"]["launches_cosy_b64"] = b64_run["launches"]["decode_b64_step"]
    rows["decode_b1_step"]["launches_cosy_zs"] = zs_launches("decode_b1_step")
    rows["wkv7_step"]["launches_cosy_zs"] = zs_launches("wkv7_step")
    rows["wkv7_fwd"]["launches_cosy_serve"] = cs_run["launches"]["wkv7_fwd"]
    rows["wkv7_step"]["launches_cosy_serve"] = cs_run["launches"]["wkv7_step"]
    xy_paths = xy_run["paths"]
    rows["wkv7_fwd"]["launches_xy"] = {k: r["launches"]["wkv7_fwd"] for k, r in xy_paths.items()}
    rows["decode_b64_step"]["launches_xy_b64"] = xy_paths["xy-0.4B-b64"]["launches"][
        "decode_b64_step"]
    rows["wkv7_step"]["launches_xy_b8"] = xy_paths["xy-0.4B-b8"]["launches"]["wkv7_step"]
    rows["wkv7_step"]["launches_xy_synthesize"] = xy_run["synthesize"]["launches"]["wkv7_step"]
    for key, path in (("launches_asr", "asr-0.4B-whisper-large-v3"),
                      ("launches_s2s", "s2s-0.4B-b32"), ("launches_two_tower", "two-tower-0.4B-b16")):
        rows["wkv7_fwd"][key] = asr_run[path]["launches"]["wkv7_fwd"]
        rows["wkv7_step"][key] = asr_run[path]["launches"]["wkv7_step"]
    rows["wkv7_fwd"]["by_shape"].update(asr_small["wkv7_fwd_times"])
    for name, k in tasks_small["kernels"].items():
        shape = {key: k[key] for key in ("B", "T", "H")}
        rows["wkv7_fused_fwd"].setdefault("by_shape", {})[name] = {
            **shape, "rel": k["rel"], "plain_fwd_ms": k["plain_fwd_ms"],
            **{key: v for key, v in k.items() if key.startswith(("fwd_", "primal_bound"))}}
        rows["wkv7_fused_bwd"].setdefault("by_shape", {})[name] = {
            **shape, "plain_bwd_ms": k["plain_bwd_ms"],
            **{key: v for key, v in k.items() if key.startswith("bwd_")}}
    unfused = tasks_small["steps"]["spark_global"]["launches"]  # LM 128 x 2, one step
    rows["wkv7_fwd"]["launches_train_task_unfused_step"] = unfused["wkv7_fwd"]
    rows["wkv7_bwd"]["launches_train_task_unfused_step"] = unfused["wkv7_bwd"]
    for key in ("wkv7_fused_fwd", "wkv7_fused_bwd"):
        i = key == "wkv7_fused_bwd"
        rows[key]["launches_train_tasks_a_step"] = {
            t: r["fused_launches_a_step"][i] for t, r in tasks_run.items()
            if "fused_launches_a_step" in r}
    rows["wkv7_step"]["asr_s2s_two_tower"] = asr_small["wkv7_step_times"]
    for lang in ("zh", "en"):
        rows["wkv7_fwd"][f"launches_cosy_long_{lang}"] = long_run[lang]["launches"]["wkv7_fwd"]
        rows["decode_b1_step"][f"launches_cosy_long_{lang}"] = long_run[lang]["launches"][
            "decode_b1_step"]
    for i, key in enumerate(("wkv7_fused_fwd", "wkv7_fused_bwd")):
        rows[key]["launches_mark_phonemes_a_step"] = mark_run["fused_launches_a_step"][i]
    for key in ("wkv7_fwd", "wkv7_step"):
        rows[key]["launches_seed_tts_a_transcribe"] = seed_run["launches_a_transcribe"][key]
        rows[key]["launches_greedy_spark_generate"] = greedy_run["launches"][key]
    for key in ("wkv7_fwd", "wkv7_fused_fwd", "wkv7_fused_bwd", "wkv7_step"):
        rows[key]["launches_ranking_demo"] = rank_run["launches"][key]
    for i, key in enumerate(("wkv7_fused_fwd", "wkv7_fused_bwd")):
        rows[key]["launches_train_wds_a_step"] = raw_run["train"]["fused_launches_a_step"][i]
        rows[key]["launches_train_wds_spark_properties"] = raw_run["train"][
            "spark_properties"]["fused_launches"][i]
    for key, n in raw_run["export"]["launches"].items():
        rows[key]["launches_export_forwards"] = n
    for policy, r in train_run["remat"].items():
        if policy == "default":
            continue
        rows["wkv7_fused_fwd"][f"launches_a_step_remat_{policy}"] = r["launches_a_step"][
            "wkv7_fused_fwd"]
        rows["wkv7_fused_bwd"][f"launches_a_step_remat_{policy}"] = r["launches_a_step"][
            "wkv7_fused_bwd"]
    for mode in ("int8", "int4"):
        rows["wkv7_step"][f"launches_cosy_quant_serve_{mode}"] = cq_run[mode]["launches"][
            "wkv7_step"]
        rows["wkv7_fwd"][f"launches_cosy_quant_serve_{mode}"] = cq_run[mode]["launches"][
            "wkv7_fwd"]
    rows["wkv7_step"]["launches_serve_int4_request"] = serve_run["int4_request"]["wkv7_step"]
    rows["decode_b64_step"]["launches_quant_quality_mega"] = qq_run["mega_launches"]
    fsdp_step, sp_step = (dist_run[k]["launches_a_step"][0] for k in ("fsdp2", "sp2"))
    for key in ("wkv7_fused_fwd", "wkv7_fused_bwd"):
        rows[key]["launches_dist_fsdp2_a_step_a_rank"] = fsdp_step[key]
    for key in ("wkv7_fwd", "wkv7_bwd"):
        rows[key]["launches_dist_sp2_a_step_a_rank"] = sp_step[key]
        rows[key]["launches_sp_route_a_call"] = dist_small["route"]["random"]["launches"][key]
    rows["wkv7_step"]["launches_dp_pool_a_step_a_group"] = pool_run["launches_a_step_a_group"]
    print("train: " + json.dumps({k: v for k, v in train_run.items()
                                  if k not in ("launches", "unfused")}))
    print("cosy: " + json.dumps({k: v for k, v in cosy_run.items() if k != "launches"}))
    print("serve: " + json.dumps({k: v for k, v in serve_run.items() if k != "launches"}))
    print("spark wav: " + json.dumps(wav_run))
    print("cosy zs: " + json.dumps(zs_run))
    print("cosy b64: " + json.dumps({k: v for k, v in b64_run.items() if k != "by_kernel"}))
    print("cosy serve: " + json.dumps({k: v for k, v in cs_run.items() if k != "launches"}))
    print("xy: " + json.dumps(xy_run))
    print("asr: " + json.dumps({"small": asr_small, "main": asr_run}))
    print("train tasks: " + json.dumps({"small": tasks_small, "main": tasks_run}))
    print("long: " + json.dumps({"cosy_long": long_run, "mark_phonemes": mark_run,
                                 "seed_tts": seed_run, "ranking_demo": rank_run,
                                 "greedy_spark_generate": greedy_run}))
    print("raw audio: " + json.dumps(raw_run))
    print("quant: " + json.dumps({"small": quant_small, "cosy_quant_serve": cq_run,
                                  "quant_quality": qq_run, "flow_noncausal": flow_nc,
                                  "remat": train_run["remat"],
                                  "serve_int4": serve_run["int4_request"],
                                  "interactive_cli": wav_run["interactive_cli"]}))
    print("dist: " + json.dumps({"nccl": nccl_run, "small": dist_small, "main": dist_run,
                                 "dp_pool": pool_run}))
    seconds["total"] = round(time.perf_counter() - t_start, 1)
    print("phase seconds: " + json.dumps(seconds))
    print(json.dumps({"kernels": [rows[k] for k in ("wkv7_fwd", "decode_b64_step", "wkv7_bwd",
                                                    "wkv7_fused_fwd", "wkv7_fused_bwd",
                                                    "decode_b1_step", "wkv7_step")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
