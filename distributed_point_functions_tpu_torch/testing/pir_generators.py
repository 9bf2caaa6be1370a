"""Test-data generators and database fakes for PIR tests (the port's copy
of the JAX package's `testing/pir_generators.py`).

Mirrors the reference's `pir/testing/mock_pir_database.h:36-90`:

* `generate_counting_strings(n, prefix)` — the i-th element is
  ``f"{prefix}{i}"`` (reference `mock_pir_database.cc` GenerateCountingStrings).
* `generate_random_strings(element_sizes)` / `..._equal_size` /
  `..._variable_size` — random byte strings with the given size profile.
* `create_fake_database(database_cls, elements, builder=None)` — inserts all
  elements through the Builder seam (`mock_pir_database.h:77-90`).
* `MockPirDatabase` — a programmable stand-in for the database interface
  (the Python analog of the reference's gMock `MockPirDatabase`): every
  method delegates to an injectable callable so tests can fake or count
  calls without a device round-trip.
"""

from __future__ import annotations

import secrets
from typing import Callable, List, Optional, Sequence


def generate_counting_strings(num_elements: int, prefix: str | bytes) -> List[bytes]:
    """`num_elements` database elements; the i-th is `prefix` + str(i)."""
    if num_elements < 0:
        raise ValueError("`num_elements` must be non-negative")
    if isinstance(prefix, str):
        prefix = prefix.encode()
    return [prefix + str(i).encode() for i in range(num_elements)]


def generate_random_strings(element_sizes: Sequence[int]) -> List[bytes]:
    """Random elements with the exact sizes in `element_sizes`."""
    for size in element_sizes:
        if size < 0:
            raise ValueError("element sizes must be non-negative")
    return [secrets.token_bytes(size) for size in element_sizes]


def generate_random_strings_equal_size(
    num_elements: int, element_size: int
) -> List[bytes]:
    if num_elements < 0:
        raise ValueError("`num_elements` must be non-negative")
    return generate_random_strings([element_size] * num_elements)


def generate_random_strings_variable_size(
    num_elements: int, avg_element_size: int, max_size_diff: int
) -> List[bytes]:
    """Sizes uniform in [avg_element_size - max_size_diff, avg + max_size_diff]."""
    if num_elements < 0:
        raise ValueError("`num_elements` must be non-negative")
    if max_size_diff < 0 or max_size_diff > avg_element_size:
        raise ValueError(
            "`max_size_diff` must be in [0, avg_element_size]"
        )
    sizes = [
        avg_element_size
        - max_size_diff
        + secrets.randbelow(2 * max_size_diff + 1)
        for _ in range(num_elements)
    ]
    return generate_random_strings(sizes)


def create_fake_database(database_cls, elements: Sequence, builder=None):
    """Builds a `database_cls` holding `elements` via its Builder."""
    if builder is None:
        builder = database_cls.Builder()
    for element in elements:
        builder.insert(element)
    return builder.build()


class MockPirClient:
    """Programmable client fake (analog of the reference's gMock
    `MockPirClient`, `pir/testing/mock_pir_client.h:30-41`): overwrite
    `on_create_request` / `on_handle_response` per test and inspect the
    recorded calls."""

    def __init__(self):
        self.create_request_calls: List = []
        self.handle_response_calls: List = []
        self.on_create_request: Optional[Callable] = None
        self.on_handle_response: Optional[Callable] = None

    def create_request(self, query_indices):
        self.create_request_calls.append(list(query_indices))
        if self.on_create_request is not None:
            return self.on_create_request(query_indices)
        raise NotImplementedError(
            "set `on_create_request` to fake request creation"
        )

    def handle_response(self, response, client_state):
        self.handle_response_calls.append((response, client_state))
        if self.on_handle_response is not None:
            return self.on_handle_response(response, client_state)
        raise NotImplementedError(
            "set `on_handle_response` to fake response handling"
        )


class MockPirDatabase:
    """Programmable database fake (Python analog of the gMock mock).

    Each behavior is a plain attribute holding a callable; tests overwrite
    what they need and read `inner_product_calls` to assert invocations.
    """

    class Builder:
        def __init__(self):
            self.inserted: List = []
            self.on_build: Optional[Callable[[], "MockPirDatabase"]] = None

        def insert(self, value) -> "MockPirDatabase.Builder":
            self.inserted.append(value)
            return self

        def clone(self) -> "MockPirDatabase.Builder":
            b = MockPirDatabase.Builder()
            b.inserted = list(self.inserted)
            b.on_build = self.on_build
            return b

        def build(self) -> "MockPirDatabase":
            if self.on_build is not None:
                return self.on_build()
            db = MockPirDatabase()
            db.records = list(self.inserted)
            return db

    def __init__(self):
        self.records: List = []
        self.inner_product_calls: List = []
        self.on_inner_product: Optional[Callable] = None

    @property
    def size(self) -> int:
        return len(self.records)

    @property
    def num_selection_bits(self) -> int:
        return max(128, ((len(self.records) + 127) // 128) * 128)

    def inner_product_with(self, selections):
        self.inner_product_calls.append(selections)
        if self.on_inner_product is not None:
            return self.on_inner_product(selections)
        raise NotImplementedError(
            "set `on_inner_product` to fake inner products"
        )
