"""AES-256-CBC — the src/crypto/ctaes + src/crypto/aes.{h,cpp} equivalent.

The reference vendors ctaes (a constant-time bitsliced C implementation)
solely for wallet encryption (src/wallet/crypter.cpp). Python's stdlib has
no AES and this environment installs nothing, so this is a small table-based
FIPS-197 implementation. Wallet encryption is not a consensus or hot path —
it runs a handful of times per unlock — so clarity beats constant-time here
(the host Python runtime leaks timing everywhere regardless; the threat
model for wallet files is offline theft, where timing is moot).

Tested against the FIPS-197 / NIST SP 800-38A known-answer vectors in
tests/unit/test_aes.py.
"""

from __future__ import annotations

# -- tables -------------------------------------------------------------------

_SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16"
)
_INV_SBOX = bytearray(256)
for i, v in enumerate(_SBOX):
    _INV_SBOX[v] = i
_INV_SBOX = bytes(_INV_SBOX)

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36,
         0x6C, 0xD8, 0xAB, 0x4D)


def _xtime(a: int) -> int:
    a <<= 1
    if a & 0x100:
        a ^= 0x11B
    return a & 0xFF


_MUL = [[0] * 256 for _ in range(16)]
for x in range(256):
    _MUL[1][x] = x
    _MUL[2][x] = _xtime(x)
    _MUL[3][x] = _MUL[2][x] ^ x
for x in range(256):
    _MUL[9][x] = _MUL[2][_MUL[2][_MUL[2][x]]] ^ x
    _MUL[11][x] = _MUL[2][_MUL[2][_MUL[2][x]] ^ x] ^ x
    _MUL[13][x] = _MUL[2][_MUL[2][_MUL[2][x] ^ x]] ^ x
    _MUL[14][x] = _MUL[2][_MUL[2][_MUL[2][x] ^ x] ^ x]


def _expand_key(key: bytes) -> list[bytes]:
    """Key schedule -> list of 16-byte round keys (15 for AES-256)."""
    assert len(key) == 32
    nk, rounds = 8, 14
    words = [key[4 * i:4 * i + 4] for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        t = words[i - 1]
        if i % nk == 0:
            t = bytes(_SBOX[b] for b in t[1:] + t[:1])
            t = bytes([t[0] ^ _RCON[i // nk - 1], t[1], t[2], t[3]])
        elif i % nk == 4:
            t = bytes(_SBOX[b] for b in t)
        words.append(bytes(a ^ b for a, b in zip(words[i - nk], t)))
    return [b"".join(words[4 * r:4 * r + 4]) for r in range(rounds + 1)]


def _encrypt_block(block: bytes, rks: list[bytes]) -> bytes:
    s = bytearray(a ^ b for a, b in zip(block, rks[0]))
    for rnd in range(1, len(rks)):
        # SubBytes + ShiftRows (column-major state, row r shifts left by r)
        t = bytearray(16)
        for c in range(4):
            for r in range(4):
                t[4 * c + r] = _SBOX[s[4 * ((c + r) % 4) + r]]
        s = t
        if rnd != len(rks) - 1:  # MixColumns
            m = bytearray(16)
            for c in range(4):
                col = s[4 * c:4 * c + 4]
                m[4 * c + 0] = _MUL[2][col[0]] ^ _MUL[3][col[1]] ^ col[2] ^ col[3]
                m[4 * c + 1] = col[0] ^ _MUL[2][col[1]] ^ _MUL[3][col[2]] ^ col[3]
                m[4 * c + 2] = col[0] ^ col[1] ^ _MUL[2][col[2]] ^ _MUL[3][col[3]]
                m[4 * c + 3] = _MUL[3][col[0]] ^ col[1] ^ col[2] ^ _MUL[2][col[3]]
            s = m
        s = bytearray(a ^ b for a, b in zip(s, rks[rnd]))
    return bytes(s)


def _decrypt_block(block: bytes, rks: list[bytes]) -> bytes:
    s = bytearray(a ^ b for a, b in zip(block, rks[-1]))
    for rnd in range(len(rks) - 2, -1, -1):
        # InvShiftRows + InvSubBytes
        t = bytearray(16)
        for c in range(4):
            for r in range(4):
                t[4 * ((c + r) % 4) + r] = _INV_SBOX[s[4 * c + r]]
        s = t
        s = bytearray(a ^ b for a, b in zip(s, rks[rnd]))
        if rnd != 0:  # InvMixColumns
            m = bytearray(16)
            for c in range(4):
                col = s[4 * c:4 * c + 4]
                m[4 * c + 0] = _MUL[14][col[0]] ^ _MUL[11][col[1]] ^ _MUL[13][col[2]] ^ _MUL[9][col[3]]
                m[4 * c + 1] = _MUL[9][col[0]] ^ _MUL[14][col[1]] ^ _MUL[11][col[2]] ^ _MUL[13][col[3]]
                m[4 * c + 2] = _MUL[13][col[0]] ^ _MUL[9][col[1]] ^ _MUL[14][col[2]] ^ _MUL[11][col[3]]
                m[4 * c + 3] = _MUL[11][col[0]] ^ _MUL[13][col[1]] ^ _MUL[9][col[2]] ^ _MUL[14][col[3]]
            s = m
    return bytes(s)


# -- public API (mirrors AES256CBCEncrypt/Decrypt, src/crypto/aes.h) ----------

def aes256_cbc_encrypt(key: bytes, iv: bytes, data: bytes,
                       pad: bool = True) -> bytes:
    """AES256CBCEncrypt: PKCS7-padded CBC encryption."""
    assert len(key) == 32 and len(iv) == 16
    if pad:
        n = 16 - len(data) % 16
        data = data + bytes([n]) * n
    elif len(data) % 16:
        raise ValueError("unpadded data must be block-aligned")
    rks = _expand_key(key)
    out = bytearray()
    prev = iv
    for i in range(0, len(data), 16):
        block = bytes(a ^ b for a, b in zip(data[i:i + 16], prev))
        prev = _encrypt_block(block, rks)
        out += prev
    return bytes(out)


def aes256_cbc_decrypt(key: bytes, iv: bytes, data: bytes,
                       pad: bool = True) -> bytes:
    """AES256CBCDecrypt; raises ValueError on bad padding (the reference
    returns 0 length — callers treat both as 'wrong passphrase')."""
    assert len(key) == 32 and len(iv) == 16
    if len(data) % 16 or not data:
        raise ValueError("ciphertext not block-aligned")
    rks = _expand_key(key)
    out = bytearray()
    prev = iv
    for i in range(0, len(data), 16):
        block = data[i:i + 16]
        out += bytes(a ^ b for a, b in zip(_decrypt_block(block, rks), prev))
        prev = block
    if pad:
        n = out[-1]
        if not 1 <= n <= 16 or out[-n:] != bytes([n]) * n:
            raise ValueError("bad padding")
        del out[-n:]
    return bytes(out)
