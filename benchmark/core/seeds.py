"""Seeds derived from the run's --seed: one stream per purpose, any whole number in."""

import hashlib


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for `purpose` (weights, traffic, noise, ...) from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
