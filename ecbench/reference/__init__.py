"""The benchmark's plain reference: GF(2^8) and the plugins' generator
matrices (``gf``), CRC32C (``crc32c``), Ceph's EC layout, encode and
HashInfo (``ec``), and the replay that decides ``correct`` (``check``).

It imports nothing of the program and takes nothing the program made:
it is handed the inputs the benchmark generated (the payload pools and
the op log) and the bytes it reads back from the client and the
stores, and works out every expected byte again itself.
"""
