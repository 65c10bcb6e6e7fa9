"""Audio/model constants shared across the framework.

Copy of ``whisper_char_alignment_tpu/constants.py`` for the PyTorch port, which
imports nothing of the JAX package; only imports changed.

Mirrors the constants the reference pulls from ``whisper.audio`` and hard-codes in
its CLIs (reference: infer_ali.py:25-26, 179-180; whisper.audio SAMPLE_RATE/HOP_LENGTH/
N_FFT/N_MELS/CHUNK_LENGTH).
"""

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000 samples in a 30 s window
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames in a 30 s window
N_MELS = 80

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # 320: one encoder position covers 2 mel frames
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100 mel frames per second
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50 encoder positions per second
AUDIO_SAMPLES_PER_TOKEN = N_SAMPLES_PER_TOKEN  # reference alias (infer_ali.py:179)
AUDIO_TIME_PER_TOKEN = N_SAMPLES_PER_TOKEN / SAMPLE_RATE  # 0.02 s per encoder position

# Capacity limits per utterance (reference: infer_ali.py:25-26).
MAX_FRAMES = 1500  # encoder positions (30 s of audio)
MAX_LENGTH = 448  # decoder tokens (n_text_ctx)
