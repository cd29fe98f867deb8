"""Typed error taxonomy for the BandJAM XA engine.

The reference C library reports failures through ``errno`` with a documented
taxonomy (reference: ``bjxa.3.rst.in:205-276``).  This engine mirrors that
contract as a small exception hierarchy; every exception carries the matching
``errno`` value so differential tests can compare against the C binary and
callers can dispatch on either the type or the errno code.

Mapping (reference errno -> exception):

=========  ==============================  =====================================
errno      exception                       raised when
=========  ==============================  =====================================
EFAULT     BjxaFault                       null/invalid object or buffer handle
EINVAL     BjxaInvalidState                misuse of an uninitialized codec
ENOBUFS    BjxaBufferError                 destination/source buffer too small
EPROTO     BjxaProtocolError               malformed XA/RIFF stream contents
EIO        BjxaIOError                     short read / truncated stream
EBADF      BjxaBadFileError                unwritable/unreadable file object
=========  ==============================  =====================================
"""

from __future__ import annotations

import errno as _errno

__all__ = [
    "BjxaError",
    "BjxaFault",
    "BjxaInvalidState",
    "BjxaBufferError",
    "BjxaProtocolError",
    "BjxaIOError",
    "BjxaBadFileError",
]


class BjxaError(Exception):
    """Base class for every bjxa-tpu failure. Carries a POSIX errno code."""

    errno: int = 0

    def __init__(self, message: str = ""):
        super().__init__(message or self.__class__.__name__)
        self.message = message


class BjxaFault(BjxaError):
    """A required object/buffer is missing (reference: EFAULT)."""

    errno = _errno.EFAULT


class BjxaInvalidState(BjxaError):
    """Codec object used before initialization or after close (EINVAL)."""

    errno = _errno.EINVAL


class BjxaBufferError(BjxaError):
    """A caller-provided buffer is too small (ENOBUFS)."""

    errno = _errno.ENOBUFS


class BjxaProtocolError(BjxaError):
    """The XA/RIFF stream violates the format specification (EPROTO)."""

    errno = _errno.EPROTO


class BjxaIOError(BjxaError):
    """A read ended prematurely or the medium failed (EIO)."""

    errno = _errno.EIO


class BjxaBadFileError(BjxaError):
    """The file object cannot be used in the requested direction (EBADF)."""

    errno = _errno.EBADF
