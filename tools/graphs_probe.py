#!/usr/bin/env python3
"""Checks on one NVIDIA GPU that the CUDA-graph paths rest on, then
``chip_smoke.py``'s ``graphs`` phase alone.

    python tools/graphs_probe.py [--no-phase]

Prints one JSON line per check:

* ``torch``: the versions, and whether ``torch.cuda.CUDAGraph`` takes
  ``keep_graph`` and has ``register_generator_state``;
* ``adam_lr``: fused capturable Adam stepped with a float learning rate and
  with the same value in a device scalar: bit-equal parameters and moments
  after 3 steps (the port's Palette optimizer writes a device scalar);
* ``lerp``: ``torch._foreach_lerp_`` with a float weight against a list of
  one device scalar per tensor (what a graph of the EMA update records):
  bit-equal, at a weight under and over one half;
* ``generator_states``: draws from per-step generator states switched in
  with ``graphsafe_set_state`` inside one graph, each seeded before the
  replay, against the same draws made eagerly after ``manual_seed``;

then the ``graphs`` phase of ``chip_smoke.py`` (the kernels built first) and
the seconds it took. Exits non-zero where a check fails.
"""

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    if not torch.cuda.is_available():
        print("graphs_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    ok = True
    emit({"check": "torch", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "keep_graph": "keep_graph" in (torch.cuda.CUDAGraph.__doc__ or ""),
          "register_generator_state": hasattr(torch.cuda.CUDAGraph,
                                              "register_generator_state")})

    gen = torch.Generator(device=device).manual_seed(1)
    shapes = [(300, 7), (64,), (3, 3, 16, 16)]
    params = [[torch.randn(s, generator=gen, device=device)
               .requires_grad_() for s in shapes] for _ in range(2)]
    with torch.no_grad():
        for a, b in zip(*params):
            b.copy_(a)
    lrs = [3.3333e-05, 4.0e-05, 5.5e-05]
    opts = [torch.optim.Adam(params[0], lr=1e-4, betas=(0.9, 0.999),
                             eps=1e-8, fused=True, capturable=True),
            torch.optim.Adam(params[1], lr=torch.tensor(1e-4, device=device),
                             betas=(0.9, 0.999), eps=1e-8, fused=True,
                             capturable=True)]
    for lr in lrs:
        grads = [torch.randn(s, generator=gen, device=device) for s in shapes]
        for side, opt in enumerate(opts):
            for p, g in zip(params[side], grads):
                p.grad = g.clone()
            if side == 0:
                opt.param_groups[0]["lr"] = lr
            else:
                opt.param_groups[0]["lr"].fill_(lr)
            opt.step()
    equal = all(torch.equal(a, b) for a, b in zip(*params)) and all(
        torch.equal(opts[0].state[a][key], opts[1].state[b][key])
        for a, b in zip(*params) for key in ("exp_avg", "exp_avg_sq"))
    emit({"check": "adam_lr", "bit_equal": equal})
    ok &= equal

    results = {}
    for weight in (0.0123, 0.818181):
        shadows = [[torch.randn(s, generator=gen, device=device)
                    for s in shapes] for _ in range(2)]
        for a, b in zip(*shadows):
            b.copy_(a)
        targets = [torch.randn(s, generator=gen, device=device)
                   for s in shapes]
        torch._foreach_lerp_(shadows[0], targets, weight)
        w = torch.tensor(weight, device=device)
        torch._foreach_lerp_(shadows[1], targets, [w] * len(shapes))
        results[str(weight)] = all(torch.equal(a, b)
                                   for a, b in zip(*shadows))
    emit({"check": "lerp", "bit_equal": results})
    ok &= all(results.values())

    rng = torch.Generator(device=device)
    states = [rng.clone_state() for _ in range(3)]
    graph = torch.cuda.CUDAGraph()
    for state in states:
        graph.register_generator_state(state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.rand(8, generator=rng, device=device)
    torch.cuda.current_stream().wait_stream(side)
    live = rng.graphsafe_get_state()
    with torch.cuda.graph(graph, stream=side):
        out = []
        for state in states:
            rng.graphsafe_set_state(state)
            out.append(torch.rand(1000, generator=rng, device=device))
            out.append(torch.randint(0, 2000, (4,), generator=rng,
                                     device=device))
    rng.graphsafe_set_state(live)
    for i, state in enumerate(states):
        state.manual_seed(100 + i)
    graph.replay()
    want = []
    for i in range(3):
        rng.manual_seed(100 + i)
        want.append(torch.rand(1000, generator=rng, device=device))
        want.append(torch.randint(0, 2000, (4,), generator=rng,
                                  device=device))
    equal = all(torch.equal(a, b) for a, b in zip(out, want))
    emit({"check": "generator_states", "bit_equal": equal})
    ok &= equal

    if "--no-phase" not in sys.argv:
        import chip_smoke
        from pai_tpu_torch import kernels

        kernels.load_library("ssim")
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="pai_graphs_") as workdir:
            chip_smoke.phase_graphs(device, workdir)
        emit({"check": "phase_graphs",
              "seconds": time.perf_counter() - start})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
