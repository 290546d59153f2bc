"""Ranks of the port's multi-process sharded paths, for
tests/test_torch_multihost.py (gloo, CPU shards) and the card test of
tests/test_torch_cuda_path.py (nccl, one card per rank). Imports only the
PyTorch port (no JAX).

As a script, one rank of a process group over localhost, holding SHARDS
shards (on the CPU under gloo, on cuda:RANK under nccl):
  1. multihost_compress: rank 0 writes the zlib stream to OUT;
  2. multihost_decompress_segments of 16 KiB full-flush segments: every
     rank writes what it decoded to OUT.dec.<rank>, and its `stats` moves
     to OUT.stats.<rank>.

Usage: python torch_mh_worker.py RANK WORLD PORT SHARDS LANE_BLOCK IN OUT
[BACKEND (gloo)]
"""
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_ranks(data: bytes, tmp_path, world: int, shards: int,
              lane_block: int, backend: str = "gloo",
              timeout: float = 45) -> tuple[bytes, list, list]:
    """Runs `world` ranks of this script on `data`; returns rank 0's
    stream, every rank's decoded bytes and every rank's `stats` moves.
    Each rank must end within `timeout` seconds."""
    in_path = str(tmp_path / "in.bin")
    out_path = str(tmp_path / "out.zz")
    with open(in_path, "wb") as f:
        f.write(data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), str(shards), str(lane_block), in_path, out_path,
         backend], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(out_path, "rb") as f:
        blob = f.read()
    decoded, moves = [], []
    for r in range(world):
        with open(f"{out_path}.dec.{r}", "rb") as f:
            decoded.append(f.read())
        with open(f"{out_path}.stats.{r}") as f:
            moves.append(json.load(f))
    return blob, decoded, moves


def main(argv) -> None:
    rank, world, port, shards, lane_block = map(int, argv[1:6])
    in_path, out_path = argv[6], argv[7]
    backend = argv[8] if len(argv) > 8 else "gloo"
    sys.path.insert(0, os.path.dirname(HERE))

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from zlibng_tpu_torch.ops import inflate
        from zlibng_tpu_torch.parallel.multihost import (
            multihost_compress, multihost_decompress_segments,
        )
        from zlibng_tpu_torch.stream.deflate import compress as compress_host

        with open(in_path, "rb") as f:
            data = f.read()
        devices = [f"cuda:{rank}" if backend == "nccl" else "cpu"] * shards
        out = multihost_compress(data, lane_block=lane_block,
                                 devices=devices)
        if rank == 0:
            with open(out_path, "wb") as f:
                f.write(out)
        else:
            assert out is None

        segs = [data[i:i + 16384] for i in range(0, len(data), 16384)]
        blob = b""
        starts = []
        for s in segs:
            starts.append(len(blob))
            blob += compress_host(s, level=6, wbits=-15)
        before = dict(inflate.stats)
        outs = multihost_decompress_segments(blob, starts, devices=devices)
        with open(f"{out_path}.dec.{rank}", "wb") as f:
            f.write(b"".join(outs))
        with open(f"{out_path}.stats.{rank}", "w") as f:
            json.dump({k: inflate.stats[k] - before[k] for k in before}, f)
        assert not [m for m in sys.modules
                    if m == "zlibng_tpu" or m.startswith("zlibng_tpu.")]
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
