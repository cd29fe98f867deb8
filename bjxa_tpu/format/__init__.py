"""Host-side container/format layer: XA and RIFF/WAVE headers, PCM bytes.

Headers are tiny (32/44 bytes of metadata) so they are parsed and emitted on
the host with numpy; the device compute path only ever sees dense sample blocks.
"""

from bjxa_tpu.format.xa import (
    XA_HEADER_SIZE,
    BLOCK_SAMPLES,
    XAFormat,
    parse_xa_header,
    dump_xa_header,
)
from bjxa_tpu.format.riff import (
    RIFF_HEADER_SIZE,
    RiffFormat,
    parse_riff_header,
    dump_riff_header,
)
from bjxa_tpu.format.pcm import dump_pcm, load_pcm

__all__ = [
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
]
