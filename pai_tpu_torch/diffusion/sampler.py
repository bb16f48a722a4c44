"""DDPM reverse sampler, counterpart of ``pai_tpu/diffusion/sampler.py``.

The JAX package compiles the whole chain into one ``lax.scan``: "inference
never leaves HBM". Here ``ddpm_loop`` is a Python loop over ``t = T-1 .. 0``
under ``torch.no_grad()`` that never waits for the device: ``t`` is a Python
int, the schedule lives on the device and is indexed there, noise is drawn
on the device from the generator, and kept frames go into a buffer
allocated before the loop. Noise is zeroed for ``t <= 1``, as in the
reference.

``ddpm_sample`` on a CUDA device, with no mesh installed and no draws
supplied, runs that loop as one CUDA graph (``ChainGraph``): the loop is
recorded once per (denoiser, its weights' addresses, schedule, shape,
dtype, ``capture_every``, ``learn_var``) and then replayed, one launch per
chain, where the loop enqueues some 100 UNet forwards' kernels one by one.
The replay draws from the caller's generator what the loop draws, and
leaves it where the loop does, so its result is the loop's, bit for bit.
Elsewhere (the CPU; under a mesh, whose gloo traffic a graph cannot record;
supplied draws) ``ddpm_sample`` is ``ddpm_loop``.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Callable, Optional, Tuple, Union

import torch

from pai_tpu_torch.diffusion.gaussian import p_mean_variance
from pai_tpu_torch.diffusion.schedule import DiffusionSchedule
from pai_tpu_torch.parallel.context import get_mesh_context
from pai_tpu_torch.parallel.mesh import draw_rows
from pai_tpu_torch.utils.graphs import CapturedGraph, GraphStream


def capture_steps(timesteps: int, capture_every: int) -> list:
    """The steps ``t`` whose ``y_{t-1}`` is kept, in the order the chain
    visits them; the frame count is one more (``y_T`` comes first)."""
    return [t for t in range(timesteps - 1, -1, -1) if t % capture_every == 0]


Chain = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def ddpm_sample(
    sched: DiffusionSchedule,
    denoise_fn: Callable,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    learn_var: bool = False,
    capture_every: Optional[int] = None,
    y_T: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> Chain:
    """``ddpm_loop``'s chain; on a CUDA device with no mesh installed and no
    draws supplied, as one CUDA graph (see the module docstring). A
    ``denoise_fn`` that is not an ``nn.Module`` must be a new object when
    the weights it reads move (a graph reads them where they were)."""
    if (x.is_cuda and get_mesh_context() is None and y_T is None
            and step_noise is None):
        return chain_graph(sched, denoise_fn, x, generator, learn_var,
                           capture_every).run(x, generator)
    return ddpm_loop(sched, denoise_fn, x, generator, learn_var,
                     capture_every, y_T, step_noise)


class ChainGraph:
    """The reverse chain of one (denoiser, schedule, shape, ...) recorded
    once as a CUDA graph. ``x`` is copied into the graph's input buffer
    before each replay; the draws come from a generator of the graph's own,
    set to the caller's generator's state before the replay and copied back
    after (the default generator, which torch registers with every graph,
    where the caller gives none). The outputs are copied out of the graph's
    pool. ``graph`` keeps the capture's figures (``CapturedGraph``)."""

    def __init__(self, sched: DiffusionSchedule, denoise_fn: Callable,
                 x: torch.Tensor, own_rng: bool, learn_var: bool,
                 capture_every: Optional[int]):
        self.sched = sched  # the graph reads its tensors
        self.x = x.clone()
        self.rng = torch.Generator(device=x.device) if own_rng else None
        side = GraphStream()
        with side, torch.no_grad():  # warm-up: one denoiser call
            denoise_fn(self.x, torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device),
                       sched.gammas[-1].expand(x.shape[0]))
        self.graph = CapturedGraph(
            lambda: ddpm_loop(sched, denoise_fn, self.x, self.rng, learn_var,
                              capture_every),
            side.stream, [self.rng] if own_rng else [])

    def run(self, x: torch.Tensor,
            generator: Optional[torch.Generator]) -> Chain:
        self.x.copy_(x)
        if self.rng is not None:
            self.rng.set_state(generator.get_state())
        self.graph.replay()
        if self.rng is not None:
            generator.set_state(self.rng.get_state())
        out = self.graph.output
        return tuple(o.clone() for o in out) if isinstance(out, tuple) \
            else out.clone()


# denoiser -> (key, ChainGraph): the chain last recorded for it, dropped with
# the denoiser or when a call needs another key
chain_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def chain_graph(sched: DiffusionSchedule, denoise_fn: Callable,
                x: torch.Tensor, generator: Optional[torch.Generator],
                learn_var: bool, capture_every: Optional[int]) -> ChainGraph:
    """The ``ChainGraph`` of this call, recorded where none fits."""
    weights = ()
    if isinstance(denoise_fn, torch.nn.Module):
        weights = tuple(t.data_ptr() for t in itertools.chain(
            denoise_fn.parameters(), denoise_fn.buffers()))
    key = (id(sched), tuple(x.shape), x.dtype, x.device, generator is None,
           learn_var, capture_every, weights)
    entry = chain_graphs.get(denoise_fn)
    if entry is None or entry[0] != key:
        chain_graphs.pop(denoise_fn, None)  # its pool is freed first
        entry = (key, ChainGraph(sched, denoise_fn, x, generator is not None,
                                 learn_var, capture_every))
        chain_graphs[denoise_fn] = entry
    return entry[1]


def ddpm_loop(
    sched: DiffusionSchedule,
    denoise_fn: Callable,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    learn_var: bool = False,
    capture_every: Optional[int] = None,
    y_T: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> Chain:
    """Run the full reverse chain conditioned on ``x`` [N,H,W,C].

    ``denoise_fn(x, y_t, gamma[N]) -> model_output`` is the eval-mode UNet.
    Returns ``y_0`` — and, if ``capture_every`` is set, the kept frames
    ``[N, F, H, W, C]``: ``y_T`` first, then ``y_{t-1}`` at every
    ``t % capture_every == 0`` (F = 9 for 100 steps and ``100 // 7``).

    ``generator`` (on ``x``'s device) draws ``y_T`` and the per-step noise;
    ``y_T`` and ``step_noise`` ([T, N, H, W, C], raw, ordered t = T-1 .. 0)
    may be supplied instead so that two implementations can be fed the same
    draws.
    """
    n = x.shape[0]
    with torch.no_grad():
        if y_T is None:
            y_T = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, device=x.device,
                dtype=torch.float32), x.shape)
        y_t = y_T.to(device=x.device, dtype=torch.float32)
        frames = None
        if capture_every:
            n_frames = 1 + len(capture_steps(sched.timesteps, capture_every))
            frames = torch.empty((n, n_frames) + tuple(y_t.shape[1:]),
                                 dtype=torch.float32, device=x.device)
            frames[:, 0] = y_t
            slot = 1
        for i, t in enumerate(range(sched.timesteps - 1, -1, -1)):
            gamma = sched.gammas[t].expand(n)
            model_output = denoise_fn(x, y_t, gamma)
            mean, log_variance = p_mean_variance(sched, model_output, y_t, t,
                                                 learn_var)
            # one draw per step, used or not, so the stream does not depend
            # on where the masking starts
            noise = step_noise[i].to(x.device) if step_noise is not None \
                else draw_rows(lambda shape: torch.randn(
                    shape, generator=generator, device=x.device,
                    dtype=torch.float32), y_t.shape)
            y_t = mean + torch.exp(0.5 * log_variance) * noise if t > 1 \
                else mean
            if capture_every and t % capture_every == 0:
                frames[:, slot] = y_t
                slot += 1
    if capture_every:
        return y_t, frames
    return y_t
