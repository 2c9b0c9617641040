"""AES-128 in ECB mode over numpy, many blocks at once.

MySQL's AES_ENCRYPT / AES_DECRYPT default to ``block_encryption_mode =
aes-128-ecb`` with PKCS7 padding (reference
pkg/expression/builtin_encryption.go, pkg/util/encrypt/aes.go). The JAX
package calls the ``cryptography`` package once per value; the card's
machine has no such package, and the port runs these functions once per
dictionary entry, so this module encrypts every entry's blocks in one
vectorized pass instead: byte ``r + 4 * c`` of a block is row r of
column c (FIPS-197's layout) and each round is a
few table gathers and XORs. The state is held transposed, ``[16, n]``,
so that each byte position is one contiguous row.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _gf_mul(a: int, b: int) -> int:
    """a * b in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1
        b >>= 1
    return out


def _sbox() -> np.ndarray:
    """FIPS-197's S-box: the multiplicative inverse, then the affine map."""
    inv = [0] * 256
    for a in range(1, 256):
        # a^254 = a^-1 (the multiplicative group has order 255)
        x, e, base = 1, 254, a
        while e:
            if e & 1:
                x = _gf_mul(x, base)
            base = _gf_mul(base, base)
            e >>= 1
        inv[a] = x
    out = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        x = inv[a]
        y = x
        for k in range(1, 5):
            y ^= ((x << k) | (x >> (8 - k))) & 0xFF
        out[a] = y ^ 0x63
    return out


_SBOX = _sbox()
_INV_SBOX = np.argsort(_SBOX).astype(np.uint8)
_MUL = {k: np.array([_gf_mul(a, k) for a in range(256)], dtype=np.uint8)
        for k in (2, 3, 9, 11, 13, 14)}
# ShiftRows moves byte r + 4 * ((c + r) % 4) to r + 4 * c
_SHIFT = np.array([r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)])
_INV_SHIFT = np.argsort(_SHIFT)


def expand_key(key: bytes) -> np.ndarray:
    """The 11 round keys of a 16-byte key, as [11, 16] uint8."""
    assert len(key) == 16
    w = [list(key[i:i + 4]) for i in range(0, 16, 4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(_SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _gf_mul(rcon, 2)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, dtype=np.uint8).reshape(11, 16)


def _mix(s: np.ndarray, m: tuple) -> np.ndarray:
    """(Inv)MixColumns of a [16, n] state with coefficient row `m`,
    rotated per output row."""
    out = np.empty_like(s)
    for c in range(4):
        col = s[4 * c: 4 * c + 4]
        prod = {(j, k): col[j] if k == 1 else _MUL[k][col[j]]
                for j in range(4) for k in set(m)}
        for r in range(4):
            acc = prod[(0, m[-r % 4])]
            for j in range(1, 4):
                acc = acc ^ prod[(j, m[(j - r) % 4])]
            out[4 * c + r] = acc
    return out


def encrypt_blocks(blocks: np.ndarray, rk: np.ndarray) -> np.ndarray:
    """[n, 16] plaintext blocks -> [n, 16] ciphertext under round keys `rk`."""
    rkt = rk[:, :, None]
    s = np.ascontiguousarray(blocks.T) ^ rkt[0]
    for rnd in range(1, 10):
        s = _mix(_SBOX[s][_SHIFT], (2, 3, 1, 1)) ^ rkt[rnd]
    return (_SBOX[s][_SHIFT] ^ rkt[10]).T


def decrypt_blocks(blocks: np.ndarray, rk: np.ndarray) -> np.ndarray:
    rkt = rk[:, :, None]
    s = np.ascontiguousarray(blocks.T) ^ rkt[10]
    for rnd in range(9, 0, -1):
        s = _mix(_INV_SBOX[s[_INV_SHIFT]] ^ rkt[rnd], (14, 11, 13, 9))
    return (_INV_SBOX[s[_INV_SHIFT]] ^ rkt[0]).T


def mysql_key(key: bytes, bits: int = 128) -> bytes:
    """MySQL's key folding: the key bytes XORed cyclically into a
    bits/8-byte buffer (reference pkg/util/encrypt/aes.go DeriveKeyMySQL)."""
    n = bits // 8
    out = bytearray(n)
    for i, b in enumerate(key):
        out[i % n] ^= b
    return bytes(out)


def _split(flat: np.ndarray, lens: List[int]) -> List[bytes]:
    raw = np.ascontiguousarray(flat).tobytes()
    out, off = [], 0
    for n in lens:
        out.append(raw[off:off + n])
        off += n
    return out


def encrypt_many(values: List[bytes], key: bytes) -> List[bytes]:
    """PKCS7-padded AES-128-ECB of each value under the 16-byte `key`."""
    rk = expand_key(key)
    padded = [v + bytes([16 - len(v) % 16]) * (16 - len(v) % 16) for v in values]
    if not padded:
        return []
    flat = np.frombuffer(b"".join(padded), dtype=np.uint8).reshape(-1, 16)
    return _split(encrypt_blocks(flat, rk), [len(p) for p in padded])


def decrypt_many(values: List[bytes], key: bytes) -> List[Optional[bytes]]:
    """Each value decrypted and unpadded; None where it is empty, not a
    whole number of blocks, or its padding is malformed."""
    rk = expand_key(key)
    ok = [bool(v) and len(v) % 16 == 0 for v in values]
    good = [v for v, k in zip(values, ok) if k]
    plain = iter(_split(decrypt_blocks(np.frombuffer(b"".join(good), dtype=np.uint8)
                                       .reshape(-1, 16), rk), [len(v) for v in good])
                 if good else [])
    out: List[Optional[bytes]] = []
    for k in ok:
        if not k:
            out.append(None)
            continue
        p = next(plain)
        pad = p[-1]
        out.append(p[:-pad] if 1 <= pad <= 16 and p[-pad:] == bytes([pad]) * pad else None)
    return out
