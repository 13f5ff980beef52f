"""The bytes a kernel's work needs, counted from the ops sent: each
input byte read once and each output byte written once."""

CSUM_BLOCK = 4096
CSUM_BYTES = 4


def encode_bytes(size: int, k: int, m: int) -> int:
    """A fused encode+csum of one S-byte object: S in, S*m/k parity out,
    and a 4-byte CRC32C for each 4 KiB block of all k+m shards."""
    parity = size * m // k
    csums = (size + parity) // CSUM_BLOCK * CSUM_BYTES
    return size + parity + csums


def decode_bytes(size: int, k: int, lost_data: int) -> int:
    """A degraded read of one S-byte object: k surviving chunks in, the
    lost data chunks out (none when only parity was lost)."""
    if not lost_data:
        return 0
    chunk = size // k
    return k * chunk + lost_data * chunk
