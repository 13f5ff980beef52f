"""AES-GCM secure mode — the ProtocolV2 rev-1 crypto_onwire analog.

Mirrors the design of msg/async/crypto_onwire.{h,cc}: after an
in-the-clear nonce exchange, each direction of a connection gets its
own AES-128-GCM key and a 96-bit nonce split into a fixed 4-byte salt
plus an 8-byte counter that increments per sealed frame
(crypto_onwire.cc nonce_t). Integrity comes from the AEAD tag — secure
mode REPLACES per-segment CRC, exactly as ProtocolV2's secure mode
supersedes crc mode (frames_v2.h rev-1 "secure mode").

Key derivation differs deliberately: the reference runs CephX tickets;
here a cluster pre-shared secret (the keyring role) is stretched with
HKDF-SHA256 over both peers' fresh nonces, so session keys are unique
per connection and the PSK never crosses the wire. A tampered
handshake yields mismatched keys and the first frame fails AEAD open —
the same failure surface as a forged CephX authorizer.

Replay is rejected by requiring the peer's counter to be strictly
increasing (the reference gets this from its per-session nonce
discipline).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

try:  # cryptography ships in the base image; gate anyway
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # pragma: no cover
    AESGCM = None

    class InvalidTag(Exception):
        pass


KEY_BYTES = 16       # AES-128, matching the reference's AES_GCM_128
SALT_BYTES = 4
COUNTER_BYTES = 8
NONCE_BYTES = 32     # per-peer handshake nonce


class SecurityError(Exception):
    """Authentication/decryption failure — the connection must drop."""


def available() -> bool:
    return AESGCM is not None


def _hkdf(key_material: bytes, info: bytes, length: int) -> bytes:
    """HKDF-SHA256 (RFC 5869) — extract with a fixed salt, then expand."""
    prk = hmac.new(b"ceph_tpu-hkdf-v1", key_material, hashlib.sha256).digest()
    out, block, counter = b"", b"", 1
    while len(out) < length:
        block = hmac.new(
            prk, block + info + bytes([counter]), hashlib.sha256
        ).digest()
        out += block
        counter += 1
    return out[:length]


def fresh_nonce() -> bytes:
    return os.urandom(NONCE_BYTES)


def derive_session(
    psk: bytes, nonce_c: bytes, nonce_s: bytes, is_client: bool
) -> tuple["SecureSession", "SecureSession"]:
    """(tx_session, rx_session) for this side of the connection.

    Each direction gets an independent key+salt; both peers derive the
    same material and pick tx/rx by role."""
    material = _hkdf(
        psk + nonce_c + nonce_s,
        b"connection-keys",
        2 * (KEY_BYTES + SALT_BYTES),
    )
    cs = material[: KEY_BYTES + SALT_BYTES]          # client -> server
    sc = material[KEY_BYTES + SALT_BYTES :]          # server -> client
    sess_cs = SecureSession(cs[:KEY_BYTES], cs[KEY_BYTES:])
    sess_sc = SecureSession(sc[:KEY_BYTES], sc[KEY_BYTES:])
    return (sess_cs, sess_sc) if is_client else (sess_sc, sess_cs)


class SecureSession:
    """One direction's AEAD state: key, nonce salt, frame counter."""

    def __init__(self, key: bytes, salt: bytes) -> None:
        if AESGCM is None:  # pragma: no cover
            raise SecurityError("cryptography library unavailable")
        assert len(key) == KEY_BYTES and len(salt) == SALT_BYTES
        self._aead = AESGCM(key)
        self._salt = salt
        self._tx_counter = 0
        self._rx_counter = 0

    def _nonce(self, counter: int) -> bytes:
        return self._salt + struct.pack("<Q", counter)

    def seal(self, aad: bytes, plaintext: bytes) -> tuple[int, bytes]:
        """Encrypt+authenticate; returns (counter, ciphertext||tag)."""
        self._tx_counter += 1
        ct = self._aead.encrypt(self._nonce(self._tx_counter), plaintext, aad)
        return self._tx_counter, ct

    def open(self, aad: bytes, counter: int, ciphertext: bytes) -> bytes:
        """Verify+decrypt; enforces a strictly increasing counter so a
        recorded frame cannot be replayed into the stream."""
        if counter <= self._rx_counter:
            raise SecurityError(
                f"replayed or reordered frame: counter {counter} <= "
                f"{self._rx_counter}"
            )
        try:
            pt = self._aead.decrypt(self._nonce(counter), ciphertext, aad)
        except InvalidTag as e:
            raise SecurityError("AEAD authentication failed") from e
        self._rx_counter = counter
        return pt
