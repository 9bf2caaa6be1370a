"""Test support for the port (mirrors the JAX package's `testing/`, the
reference's `pir/testing/`): the fixed hybrid keyset (`encrypt_decrypt`),
PIR test data and fakes (`pir_generators`), selection-bit packing with a
scalar inner product (`pir_selection_bits`) and a request generator
(`request_generator`)."""

from .pir_generators import (
    MockPirClient,
    MockPirDatabase,
    create_fake_database,
    generate_counting_strings,
    generate_random_strings,
    generate_random_strings_equal_size,
    generate_random_strings_variable_size,
)
from .pir_selection_bits import (
    generate_random_packed_selection_bits,
    inner_product_with_unpacked,
    pack_selection_bits,
    unpack_selection_bits_np,
)
from .request_generator import RequestGenerator

__all__ = [
    "MockPirClient",
    "MockPirDatabase",
    "RequestGenerator",
    "create_fake_database",
    "generate_counting_strings",
    "generate_random_strings",
    "generate_random_strings_equal_size",
    "generate_random_strings_variable_size",
    "generate_random_packed_selection_bits",
    "inner_product_with_unpacked",
    "pack_selection_bits",
    "unpack_selection_bits_np",
]
