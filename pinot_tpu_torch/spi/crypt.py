"""Segment crypters: applied to a segment's files around the deep store.

Counterpart of ``pinot_tpu/spi/crypt.py`` (JAX :22-105; the reference's
``PinotCrypter``, ``PinotCrypterFactory`` and ``NoOpPinotCrypter``): a
crypter encrypts a file in place before it reaches the store and
decrypts the fetched copy (``spi/filesystem.py`` ``fetch_segment``).
``KeyedStreamCrypter`` XORs with a SHA-256 counter-mode keystream, the
JAX format byte for byte (magic, 16-byte nonce, ciphertext), so each
package decrypts the other's files. The registry is keyed by name.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict

import numpy as np


class PinotCrypter:
    """The SPI: both methods transform a file IN PLACE."""

    def encrypt(self, path: str) -> None:
        raise NotImplementedError

    def decrypt(self, path: str) -> None:
        raise NotImplementedError


class NoOpPinotCrypter(PinotCrypter):
    """Ref: NoOpPinotCrypter — the default when tables opt out."""

    def encrypt(self, path: str) -> None:
        pass

    def decrypt(self, path: str) -> None:
        pass


class KeyedStreamCrypter(PinotCrypter):
    """Symmetric XOR stream cipher with a SHA-256 CTR keystream.

    Layout of an encrypted file: 16-byte random nonce || ciphertext.
    Keystream block i = SHA256(key || nonce || i_le8); XOR is its own
    inverse so decrypt re-derives the stream from the stored nonce.
    """

    _MAGIC = b"PCRY1\x00"

    def __init__(self, key: bytes):
        if not key:
            raise ValueError("empty crypter key")
        self.key = key

    def _stream(self, nonce: bytes, n: int) -> bytes:
        out = bytearray()
        i = 0
        while len(out) < n:
            out += hashlib.sha256(
                self.key + nonce + i.to_bytes(8, "little")).digest()
            i += 1
        return bytes(out[:n])

    def _xor(self, data: bytes, nonce: bytes) -> bytes:
        """``data`` XOR the keystream, a byte array at a time."""
        return (np.frombuffer(data, np.uint8)
                ^ np.frombuffer(self._stream(nonce, len(data)), np.uint8)
                ).tobytes()

    def encrypt(self, path: str) -> None:
        with open(path, "rb") as f:
            plain = f.read()
        nonce = os.urandom(16)
        cipher = self._xor(plain, nonce)
        with open(path, "wb") as f:
            f.write(self._MAGIC + nonce + cipher)

    def decrypt(self, path: str) -> None:
        with open(path, "rb") as f:
            raw = f.read()
        if not raw.startswith(self._MAGIC):
            raise ValueError(f"{path}: not a {type(self).__name__} file")
        nonce = raw[len(self._MAGIC):len(self._MAGIC) + 16]
        plain = self._xor(raw[len(self._MAGIC) + 16:], nonce)
        with open(path, "wb") as f:
            f.write(plain)


# -- registry (ref: PinotCrypterFactory.init + getPinotCrypter) -------------

_REGISTRY: Dict[str, Callable[[], PinotCrypter]] = {
    "noop": NoOpPinotCrypter,
    "nooppinotcrypter": NoOpPinotCrypter,
}


def register_crypter(name: str, ctor: Callable[[], PinotCrypter]) -> None:
    _REGISTRY[name.lower()] = ctor


def get_crypter(name: str) -> PinotCrypter:
    ctor = _REGISTRY.get(name.lower())
    if ctor is None:
        raise ValueError(f"no crypter registered under {name!r} "
                         f"(registered: {sorted(_REGISTRY)})")
    return ctor()
