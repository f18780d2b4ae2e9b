"""whisper-medium [audio] — encoder-decoder (arXiv:2212.04356).
The conv frontend is a stub, as in the reference: a request or a batch
carries precomputed frame embeddings (B, 1500, d_model).  The 448-token
decoder context is whisper's published one.

Serving: ContinuousBatchingEngine pages the decoder self-attn KV and holds
each request's encoder cross K/V in slot-state rows — the 1500-frame
encoder runs ONCE at admission on the request's ``frontend`` embeddings
(transformer.admit_slot), so decode steps never touch the encoder."""
from repro_torch.configs.base import ArchConfig, EncoderSpec, Segment

ARCH = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    attn_bias=True,
    tie_embeddings=True,
    pattern=(Segment(("wdec",), 24),),
    encoder=EncoderSpec(n_layers=24, seq_len=1500, d_ff=4096),
    frontend="audio",
)
