"""Checkpoint conversion between the JAX package's parameter trees and the
port's state dicts, and flax's msgpack format without flax."""
