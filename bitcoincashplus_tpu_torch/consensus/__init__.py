"""Consensus layer: serialization, primitives, Merkle, PoW, chain parameters."""
