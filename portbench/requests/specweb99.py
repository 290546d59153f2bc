"""Request kind `specweb99`: the response sizes of SPECweb99's static
file set (spec.org/web99).

Four classes of nine files: file k (1..9) of class c (0..3) is
k * 1024 * 10**c / 10 bytes, so 102-921 B, 1,024-9,216 B,
10,240-92,160 B and 102,400-921,600 B. The classes take 35%, 50%, 14%
and 1% of requests. One cycle is 900 requests: each file of a class
taken equally often (SPECweb99 draws files within a class by a Zipf
rule), 35, 50, 14 and 1 times, 13,524,340 B in all.
"""

CLASS_CALLS = (35, 50, 14, 1)      # requests per file of class 0..3


def sizes(params: dict, n_data: int) -> list:
    """The request sizes of one cycle, in bytes."""
    return [k * 1024 * 10 ** c // 10 for c, calls in enumerate(CLASS_CALLS)
            for k in range(1, 10) for _ in range(calls)]
