"""Shrinks every cell to a size the CPU tests can hold: the same entries,
mixes and checks on a prefix of the data (`cut_data`), and the decode
cell's archive in segments to match (`SMALL`)."""
import functools
import json

from portbench import harness

CUT = 40_000
SMALL = {
    "l6-bulk": {},
    "l6-indexed-decode": {"traffic": {"segment": 16_384}},
    "l1-bulk": {},
}
_make = harness.make_data


@functools.lru_cache(maxsize=8)
def _prefix(data_spec: str, seed: int, n: int) -> bytes:
    return _make({"data": json.loads(data_spec)}, seed)[:n]


def small_data(config: dict, seed: int, n: int = CUT) -> bytes:
    """The first `n` bytes of the configuration's data at `seed`."""
    return _prefix(json.dumps(config["data"], sort_keys=True), seed, n)


def cut_data(monkeypatch, n: int = CUT):
    """Makes every run of the test cut its data to `n` bytes."""
    monkeypatch.setattr(harness, "make_data",
                        lambda config, seed: small_data(config, seed, n))
