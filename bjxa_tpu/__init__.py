"""bjxa-tpu: a BandJAM XA audio codec engine on JAX accelerators.

Brand-new JAX/XLA/Pallas implementation with the full capabilities of the
reference C library+CLI (libbjxa/bjxa): bit-exact 4/6/8-bit mono/stereo XA
decode to 16-bit PCM WAVE, XA encode (reference-compatible truncation mode
plus a full per-block filter-profile search the reference lacks), strict
header validation with a typed errno-style error taxonomy, a streaming
incremental codec API, a compatible CLI, and corpus/multi-device scaling
through jax.sharding.
"""

__version__ = "0.5.0"

from bjxa_tpu.errors import (
    BjxaError,
    BjxaFault,
    BjxaInvalidState,
    BjxaBufferError,
    BjxaProtocolError,
    BjxaIOError,
    BjxaBadFileError,
)
from bjxa_tpu.format import (
    XA_HEADER_SIZE,
    RIFF_HEADER_SIZE,
    BLOCK_SAMPLES,
    XAFormat,
    RiffFormat,
    parse_xa_header,
    dump_xa_header,
    parse_riff_header,
    dump_riff_header,
    dump_pcm,
    load_pcm,
)
from bjxa_tpu.api import (
    decode_xa,
    decode_xa_stream,
    encode_pcm,
    encode_wav_stream,
    wav_to_xa,
    xa_to_wav,
)
from bjxa_tpu.utils.hygiene import clear_compiled_caches

__all__ = [
    "__version__",
    "BjxaError",
    "BjxaFault",
    "BjxaInvalidState",
    "BjxaBufferError",
    "BjxaProtocolError",
    "BjxaIOError",
    "BjxaBadFileError",
    "XA_HEADER_SIZE",
    "RIFF_HEADER_SIZE",
    "BLOCK_SAMPLES",
    "XAFormat",
    "RiffFormat",
    "parse_xa_header",
    "dump_xa_header",
    "parse_riff_header",
    "dump_riff_header",
    "dump_pcm",
    "load_pcm",
    "decode_xa",
    "decode_xa_stream",
    "encode_pcm",
    "encode_wav_stream",
    "wav_to_xa",
    "xa_to_wav",
    "clear_compiled_caches",
]
