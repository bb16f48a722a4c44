#!/usr/bin/env python3
"""Which collectives a gloo process group carries on CUDA tensors, and
whether NCCL takes two ranks of one communicator on one card.

    python3 tools/torch_gloo_cuda_probe.py [--ranks 2] [--timeout 120]

A machine with one GPU cannot give each rank its own card, so the port's
multi-rank checks there run their ranks on the same card over gloo. This
script spawns ``--ranks`` processes on ``cuda:0`` over gloo and calls each
collective the port's parallel layer and FSDP2 use on CUDA tensors, one after
the other, each followed by a barrier on a CPU tensor; per op it prints one
JSON line ``{"op", "ok", "correct", "error"}`` from rank 0; a world whose
processes die prints its exit code instead. Then it spawns
two ranks over NCCL on the same card and reports what the first all-reduce
does. Every world runs in processes with a hard time limit, so an op that
hangs is reported as such rather than holding the script. Without a card it
exits 1 and prints nothing else.

This is a probe: each op is called inside ``try`` so that one refusal does
not hide the next. The port itself never wraps a collective in ``try``; it
reads the group's backend (``pai_tpu_torch.parallel.distributed``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ops():
    import torch
    import torch.distributed as dist

    def all_reduce(rank, world, dev):
        t = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def broadcast(rank, world, dev):
        t = torch.full((1024,), float(rank), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 0).all())

    def all_gather(rank, world, dev):
        t = torch.full((8,), float(rank), device=dev)
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        return all(bool((o == r).all()) for r, o in enumerate(out))

    def all_gather_into_tensor(rank, world, dev):
        t = torch.full((8,), float(rank), device=dev)
        out = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(out, t)
        return bool((out.view(world, 8)
                     == torch.arange(world, device=dev)[:, None]).all())

    def reduce_scatter_tensor(rank, world, dev):
        t = torch.ones(8 * world, device=dev)
        out = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(out, t)
        return bool((out == world).all())

    def send_recv(rank, world, dev):
        t = torch.full((8,), float(rank), device=dev)
        out = torch.empty_like(t)
        if rank % 2 == 0:
            dist.send(t, (rank + 1) % world)
            dist.recv(out, (rank + 1) % world)
        else:
            dist.recv(out, (rank - 1) % world)
            dist.send(t, (rank - 1) % world)
        return bool((out == float(rank ^ 1)).all())

    def batch_isend_irecv(rank, world, dev):
        t = torch.full((8,), float(rank), device=dev)
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
               dist.P2POp(dist.irecv, out, (rank - 1) % world)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return bool((out == float((rank - 1) % world)).all())

    def fsdp2_step(rank, world, dev):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("dp",))
        g = torch.Generator(device=dev).manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Conv2d(1, 16, 3),
                                    torch.nn.Conv2d(16, 1, 3)).to(dev)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0, 0.1, generator=g)
        fully_shard(model, mesh=mesh)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, fused=True)
        x = torch.randn(2, 1, 16, 16, device=dev, generator=g)
        model(x).square().mean().backward()
        opt.step()
        full = {k: v.full_tensor() for k, v in model.state_dict().items()}
        return all(bool(torch.isfinite(v).all()) for v in full.values())

    return {"collectives": [all_reduce, broadcast, all_gather,
                            all_gather_into_tensor, reduce_scatter_tensor],
            # a refused op on CUDA tensors can end the process (gloo writes
            # from the device pointer), so each of these runs in a world of
            # its own
            "fsdp2_step": [fsdp2_step],
            "send_recv": [send_recv],
            "batch_isend_irecv": [batch_isend_irecv]}


def _gloo_rank(rank: int, world: int, port: int, ops: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    for op in _ops()[ops]:
        line = {"op": op.__name__, "backend": "gloo", "tensors": "cuda"}
        try:
            line["correct"] = op(rank, world, dev)
            torch.cuda.synchronize()
            line["ok"] = True
        except Exception as exc:  # a probe: report the refusal, go on
            line.update(ok=False, error=f"{type(exc).__name__}: "
                        + str(exc).splitlines()[0][:300])
        dist.barrier()
        if rank == 0:
            print(json.dumps(line), flush=True)
    dist.destroy_process_group()


def _nccl_rank(rank: int, world: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line = {"op": "all_reduce", "backend": "nccl", "ranks_on_one_card": world}
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world, device_id=dev)
        t = torch.ones(8, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        line.update(ok=True, correct=bool((t == world).all()))
    except Exception as exc:  # a probe: report the refusal
        line.update(ok=False, error=f"{type(exc).__name__}: "
                    + " ".join(str(exc).split())[:400])
    if rank == 0:
        print(json.dumps(line), flush=True)
    os._exit(0)  # a refused NCCL communicator may not tear down


def _world(kind: str, ranks: int, timeout: float, ops: str = "") -> int:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "--ranks", str(ranks), "--port", str(port),
                               "--kind", kind, "--ops", ops])
             for r in range(ranks)]
    code = 0
    for p in procs:
        try:
            code |= p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            code = 124
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if code == 124:
        print(json.dumps({"world": kind, "ops": ops, "hung": True,
                          "timeout_s": timeout}), flush=True)
    elif code:
        print(json.dumps({"world": kind, "ops": ops, "exit_code": code}),
              flush=True)
    return code


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--kind", default=None)
    parser.add_argument("--ops", default="")
    args = parser.parse_args(argv)
    if args.rank is not None:
        try:
            if args.kind == "gloo":
                _gloo_rank(args.rank, args.ranks, args.port, args.ops)
            else:
                _nccl_rank(args.rank, args.ranks, args.port)
        except Exception:
            traceback.print_exc()
            return 1
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "cards": torch.cuda.device_count(), "smi": smi}),
          flush=True)
    for ops in _ops():
        _world("gloo", args.ranks, args.timeout, ops)
    _world("nccl", 2, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
