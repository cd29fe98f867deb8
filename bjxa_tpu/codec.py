"""Stateful streaming codec objects — the incremental API.

Python-idiomatic equivalents of the reference's opaque
``bjxa_decoder_t``/``bjxa_encoder_t`` objects and their re-entrant
block-at-a-time contract (``src/libbjxa.c:602-661, 759-819``):

* a header may be (re)parsed at any time; parsing is transactional, so a
  failed reparse leaves prior state intact (``bjxa.3.rst.in:126-129``);
* ``decode``/``encode`` process as many whole blocks as the given buffers
  allow, mutate internal progress (``blocks``/``data_len_pcm`` count down)
  and size the final partial block correctly;
* decoding past the last block raises the EPROTO-equivalent;
* using a codec before header/init raises the EINVAL-equivalent.

The per-block work runs through the exact numpy path (the filter state is
two ints per channel; dispatching a device program per 32-sample block would
be all launch latency) — the device pipelines in :mod:`bjxa_tpu.ops` are
the whole-file/corpus fast path, exactly like the reference's
``BJXA_SINGLE_PASS`` dual-mode CLI proves both modes equivalent.
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO

import numpy as np

from bjxa_tpu.errors import (
    BjxaBadFileError,
    BjxaBufferError,
    BjxaFault,
    BjxaInvalidState,
    BjxaIOError,
    BjxaProtocolError,
)
from bjxa_tpu.format.pcm import dump_pcm, load_pcm
from bjxa_tpu.format.riff import RiffFormat, dump_riff_header, parse_riff_header
from bjxa_tpu.format.xa import (
    BLOCK_SAMPLES,
    XA_HEADER_SIZE,
    XAFormat,
    dump_xa_header,
    parse_xa_header,
)
from bjxa_tpu.format.riff import RIFF_HEADER_SIZE
from bjxa_tpu.ops import numpy_ref
from bjxa_tpu.ops.tables import NUM_FACTORS


@dataclasses.dataclass
class FormatInfo:
    """Mutable conversion-progress snapshot (the ``bjxa_format_t`` analog).

    ``blocks`` and ``data_len_pcm`` count *remaining* work and are
    decremented by ``decode``/``encode`` (reference ChangeLog 0.4 /
    ``src/libbjxa.c:654-657``).
    """

    data_len_pcm: int
    blocks: int
    block_size_pcm: int
    block_size_xa: int
    samples_rate: int
    sample_bits: int
    channels: int


def _file_writable(f) -> bool:
    try:
        return f.writable()
    except Exception:
        return False


class Decoder:
    """Streaming XA decoder with the reference's incremental contract."""

    def __init__(self):
        self._fmt: XAFormat | None = None
        self._state: np.ndarray | None = None
        self._blocks_left = 0
        self._pcm_left = 0
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Invalidate the object (the ``bjxa_free_decoder`` analog)."""
        self._check_open()
        self._closed = True
        self._fmt = None
        self._state = None

    def _check_open(self):
        if self._closed:
            raise BjxaInvalidState("decoder used after close")

    def _check_ready(self):
        self._check_open()
        if self._fmt is None:
            raise BjxaInvalidState("decoder has no parsed header")

    # -- header ------------------------------------------------------------

    def parse_header(self, buf: bytes | memoryview) -> int:
        """Parse a 32-byte XA header; transactional. Returns bytes consumed."""
        self._check_open()
        fmt = parse_xa_header(buf)  # raises without touching our state
        self._fmt = fmt
        self._state = fmt.initial_state_array()
        self._blocks_left = fmt.blocks
        self._pcm_left = fmt.data_len_pcm
        return XA_HEADER_SIZE

    def read_header(self, file: BinaryIO) -> int:
        """Read+parse the header from a binary stream."""
        self._check_open()
        if file is None:
            raise BjxaFault("read_header: no input file")
        data = file.read(XA_HEADER_SIZE)
        if data is None or len(data) < XA_HEADER_SIZE:
            raise BjxaIOError("read_header: short read")
        return self.parse_header(data)

    # -- format / progress -------------------------------------------------

    def format(self) -> FormatInfo:
        """Snapshot the output format and remaining progress."""
        self._check_ready()
        fmt = self._fmt
        return FormatInfo(
            data_len_pcm=self._pcm_left,
            blocks=self._blocks_left,
            block_size_pcm=fmt.block_size_pcm,
            block_size_xa=fmt.block_size_xa,
            samples_rate=fmt.samples_rate,
            sample_bits=16,
            channels=fmt.channels,
        )

    @property
    def xa_format(self) -> XAFormat:
        self._check_ready()
        return self._fmt

    # -- decoding ----------------------------------------------------------

    def decode(self, src: bytes | memoryview, max_blocks: int | None = None):
        """Decode whole blocks from ``src``.

        Returns interleaved ``int16[frames, channels]`` for as many
        effective blocks as ``src`` holds (bounded by ``max_blocks`` and
        remaining stream length); the final block yields only the frames
        the header promises.  Raises BjxaProtocolError if the stream is
        already exhausted or a profile factor is invalid, BjxaBufferError
        if ``src`` holds less than one block.
        """
        self._check_ready()
        if src is None:
            raise BjxaFault("decode: no source buffer")
        fmt = self._fmt
        if self._blocks_left <= 0:
            raise BjxaProtocolError("decode: stream exhausted")
        if len(src) < fmt.block_size_xa:
            raise BjxaBufferError("decode: need at least one whole XA block")

        n = min(len(src) // fmt.block_size_xa, self._blocks_left)
        if max_blocks is not None:
            n = min(n, max_blocks)
        raw = np.frombuffer(src, np.uint8, count=n * fmt.block_size_xa)
        blocks = raw.reshape(n, fmt.channels, fmt.block_size)
        state = self._state

        from bjxa_tpu import native

        if native.available():
            flat, done = native.decode_blocks(blocks, fmt.bits, state)
            out = flat[: done * BLOCK_SAMPLES]
            failed = done < n
        else:
            factors = blocks[:, :, 0].astype(np.int32) >> 4  # [n, C]
            bad = factors >= NUM_FACTORS
            failed = bool(bad.any())
            done = int(bad.any(axis=1).argmax()) if failed else n
            if done:
                out = numpy_ref.decode_lanes_fixpoint(
                    blocks[:done], fmt.bits, state
                )
            else:
                out = np.empty((0, fmt.channels), np.int16)
            if failed:
                # channel-sequential, like src/libbjxa.c:633-646: channels
                # before the failing one in the bad block still advance.
                c_bad = int(bad[done].argmax())
                for c in range(c_bad):
                    unpacked = numpy_ref.unpack_blocks(
                        blocks[done, c, 1:], fmt.bits
                    )
                    numpy_ref.filter_block(  # advances state[c]
                        unpacked, int(blocks[done, c, 0]), state[c]
                    )

        # per-block this is frames = min(32, pcm_left // frame_bytes),
        # decremented block by block; full blocks take 32 until the
        # promised tail, so the sum closes to one min()
        emitted = min(done * BLOCK_SAMPLES,
                      self._pcm_left // (2 * fmt.channels))
        self._pcm_left -= emitted * 2 * fmt.channels
        self._blocks_left -= done
        if failed:
            raise BjxaProtocolError(
                f"invalid block profile factor in block {done}"
            )
        return out[:emitted]

    # -- output ------------------------------------------------------------

    def dump_riff_header(self) -> bytes:
        self._check_ready()
        fmt = self._fmt
        return dump_riff_header(
            fmt.data_len_pcm, fmt.samples_rate, fmt.channels
        )

    def write_riff_header(self, file: BinaryIO) -> int:
        self._check_ready()
        if file is None:
            raise BjxaFault("write_riff_header: no output file")
        if not _file_writable(file):
            raise BjxaBadFileError("write_riff_header: unwritable file")
        file.write(self.dump_riff_header())
        return RIFF_HEADER_SIZE

    @staticmethod
    def write_pcm(samples: np.ndarray, file: BinaryIO) -> None:
        if file is None:
            raise BjxaFault("write_pcm: no output file")
        if not _file_writable(file):
            raise BjxaBadFileError("write_pcm: unwritable file")
        file.write(dump_pcm(samples))


class Encoder:
    """Streaming XA encoder (truncation or profile-search mode)."""

    def __init__(self):
        self._fmt: XAFormat | None = None
        self._state: np.ndarray | None = None
        self._blocks_left = 0
        self._pcm_left = 0
        self._closed = False

    def close(self) -> None:
        self._check_open()
        self._closed = True
        self._fmt = None

    def _check_open(self):
        if self._closed:
            raise BjxaInvalidState("encoder used after close")

    def _check_ready(self):
        self._check_open()
        if self._fmt is None:
            raise BjxaInvalidState("encoder not initialized")

    # -- init --------------------------------------------------------------

    def init(self, rf: RiffFormat, bits: int) -> None:
        """Initialize from a parsed WAVE format (``bjxa_encode_init``)."""
        self._check_open()
        if rf is None:
            raise BjxaFault("init: no source format")
        if bits not in (4, 6, 8):
            raise BjxaInvalidState(f"init: invalid bit depth {bits}")
        rf.validate()
        samples = rf.samples
        if samples <= 0:
            raise BjxaProtocolError("init: empty stream")
        nblocks = -(-samples // BLOCK_SAMPLES)
        block_size = bits * 4 + 1
        fmt = XAFormat(
            data_len=nblocks * block_size * rf.channels,
            samples=samples,
            samples_rate=rf.samples_rate,
            bits=bits,
            channels=rf.channels,
            initial_state=((0, 0), (0, 0)),
        ).validate()
        self._fmt = fmt
        self._state = np.zeros((rf.channels, 2), np.int32)
        self._blocks_left = fmt.blocks
        self._pcm_left = fmt.data_len_pcm

    def read_riff_header(self, file: BinaryIO, bits: int) -> int:
        self._check_open()
        if file is None:
            raise BjxaFault("read_riff_header: no input file")
        data = file.read(RIFF_HEADER_SIZE)
        if data is None or len(data) < RIFF_HEADER_SIZE:
            raise BjxaIOError("read_riff_header: short read")
        self.init(parse_riff_header(data), bits)
        return RIFF_HEADER_SIZE

    # -- format / progress -------------------------------------------------

    def format(self) -> FormatInfo:
        self._check_ready()
        fmt = self._fmt
        return FormatInfo(
            data_len_pcm=self._pcm_left,
            blocks=self._blocks_left,
            block_size_pcm=fmt.block_size_pcm,
            block_size_xa=fmt.block_size_xa,
            samples_rate=fmt.samples_rate,
            sample_bits=fmt.bits,
            channels=fmt.channels,
        )

    @property
    def xa_format(self) -> XAFormat:
        self._check_ready()
        return self._fmt

    # -- encoding ----------------------------------------------------------

    def dump_header(self) -> bytes:
        self._check_ready()
        return dump_xa_header(self._fmt)

    def write_header(self, file: BinaryIO) -> int:
        self._check_ready()
        if file is None:
            raise BjxaFault("write_header: no output file")
        if not _file_writable(file):
            raise BjxaBadFileError("write_header: unwritable file")
        file.write(self.dump_header())
        return XA_HEADER_SIZE

    def encode(
        self, pcm: bytes | memoryview | np.ndarray, *, search: bool = False
    ) -> bytes:
        """Encode whole blocks of interleaved PCM; returns XA block bytes.

        ``pcm`` may be raw little-endian int16 bytes or an
        ``int16[frames, channels]`` array.  The final (short) block is
        zero-padded exactly like the reference (``src/libbjxa.c:686-690``).
        """
        self._check_ready()
        if pcm is None:
            raise BjxaFault("encode: no source buffer")
        fmt = self._fmt
        if self._blocks_left <= 0:
            raise BjxaProtocolError("encode: stream exhausted")
        if isinstance(pcm, np.ndarray):
            frames = np.asarray(pcm, np.int16).reshape(-1, fmt.channels)
        else:
            frames = load_pcm(pcm, fmt.channels)

        frame_bytes = 2 * fmt.channels
        if frames.shape[0] * frame_bytes < min(
            fmt.block_size_pcm, self._pcm_left
        ):
            raise BjxaBufferError("encode: need at least one whole block")

        # figure out how many whole blocks this call covers
        nblocks = 0
        pos = 0
        pcm_left = self._pcm_left
        blocks_left = self._blocks_left
        while blocks_left > 0:
            want = min(fmt.block_size_pcm, pcm_left) // frame_bytes
            if frames.shape[0] - pos < want or want == 0:
                break
            pos += want
            pcm_left -= want * frame_bytes
            blocks_left -= 1
            nblocks += 1

        padded = np.zeros((nblocks * BLOCK_SAMPLES, fmt.channels), np.int16)
        padded[: min(pos, nblocks * BLOCK_SAMPLES)] = frames[:pos]

        from bjxa_tpu import native

        if native.available():
            blocks = native.encode_blocks(
                padded, fmt.bits, self._state, search=search
            )
            out = blocks.tobytes()
        elif search:
            out = self._encode_search_device(padded, nblocks)
        else:
            buf = bytearray()
            for i in range(nblocks):
                for c in range(fmt.channels):
                    prof, payload = numpy_ref.encode_truncate_block(
                        padded[i * BLOCK_SAMPLES : (i + 1) * BLOCK_SAMPLES, c],
                        fmt.bits,
                    )
                    buf.append(prof)
                    buf += payload.tobytes()
            out = bytes(buf)

        self._pcm_left = pcm_left
        self._blocks_left = blocks_left
        return out

    def _encode_search_device(self, padded: np.ndarray, nblocks: int) -> bytes:
        """Profile-search encode of the buffered blocks via the device
        kernel (fallback when the native library is unavailable)."""
        import jax.numpy as jnp

        from bjxa_tpu.ops.deflate import deflate_blocks
        from bjxa_tpu.ops.encode import encode_search

        fmt = self._fmt
        lanes = padded.astype(np.int32).reshape(
            nblocks, BLOCK_SAMPLES, fmt.channels
        )
        profiles, coded, _recon, end = encode_search(
            jnp.asarray(lanes), jnp.asarray(self._state), bits=fmt.bits
        )
        self._state = np.asarray(end)
        blocks = deflate_blocks(profiles, coded.transpose(0, 2, 1), fmt.bits)
        return np.asarray(blocks).tobytes()
