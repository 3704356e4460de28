"""The bf16 kernels' device times and the fp32 kernels' output bits of one or
more trees of the port, in turns, on one card.

    python3 tools/tensor_core_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (this one, or an older commit unpacked
with `git archive` into a directory that .gitignore lists). For each ROOT in
the order given, a fresh process imports that tree's trafficbots_tpu_torch,
builds its K1, K2, K3, K4 and K6 sources (nvcc, sm_90a) and prints one JSON
line:

  - `digests`: the SHA-1 of the kernels' outputs on seeded inputs at
    the main path's shapes: K1 and K1-bf16 on path S (the rollout's
    as2pl, B = 8, S = 64, T = 1024, bf16 K/V, a padding mask) and path L
    (the map self-attention, B = 8, S = T = 1024, and the latent as2pl,
    S = 1216);
    K3f's output and row statistics and K3b's dq, dk, dv at the as2pl and
    the map self-attention (dropout 0.1); K2's and K2-bf16's pooled output
    and K4f's and K4b's (dropout 0.1) on `ops.node_trace.inputs` (8 scenes
    of 1024 x 20 polylines at 768/1024 fill, 3 layers); K6's output on that validity
    with seeded q, k, v [8192, 20, 128], 4 heads. Two trees whose fp32
    kernels compute the same bits print the same digests;
  - `device_ms`: fp32 K1 and K3f / K3b on their digests' inputs; K1-bf16
    at its four sites (the rollout as2pl at B = 8 and
    the joint futures' B = 48, the map self-attention, the latent as2pl;
    bf16 q, k, v, a padding mask over the last quarter of the keys) beside
    SDPA on the same bf16 q/k/v, K2-bf16 beside fp32 K2, K4f and K4b, and
    K6-bf16 beside fp32 K6 (on K6's digest inputs): the bare launches
    captured in a CUDA graph and replayed, timed with CUDA events;
  - `card`: nvidia-smi's name and power limit.

Run parent, this, this, parent in one run to compare two commits on one
card. Needs an NVIDIA GPU with nvcc.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def digest(t) -> str:
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def graph_ms(torch, fn, n: int = 20, replays: int = 5) -> float:
    """Device ms a call: n calls in one CUDA graph, its replays timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (n * replays)


def attention_case(torch, seed, B, S, T, kv_bf16, full_mask, dev):
    """q, k, v (fp32; k/v bf16 with kv_bf16) and a padding mask over the
    last quarter of the keys (stride 0 over S), or a full random mask."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, n, 128, generator=gen).to(dev) for n in (S, T, T))
    if kv_bf16:
        k, v = k.bfloat16(), v.bfloat16()
    if full_mask:
        invalid = (torch.rand(B, S, T, generator=gen) < 0.25).to(dev)
    else:
        pad = torch.zeros(B, T, dtype=torch.bool)
        pad[:, 3 * T // 4:] = True
        invalid = pad.to(dev)[:, None, :].expand(B, S, T)
    return q, k, v, invalid


def one_tree(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from trafficbots_tpu_torch.ops import attention_train as AT
    from trafficbots_tpu_torch.ops import block_attn as BA
    from trafficbots_tpu_torch.ops import cuda_build
    from trafficbots_tpu_torch.ops import fused_attention as FA
    from trafficbots_tpu_torch.ops import node_encoder as NE
    from trafficbots_tpu_torch.ops import node_encoder_train as NT
    from trafficbots_tpu_torch.ops import node_trace

    assert cuda_build.CSRC.resolve().is_relative_to(Path(root).resolve()), cuda_build.CSRC
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build_all(("fused_attention", "attention_train", "node_encoder", "node_encoder_train", "block_attn"))
    digests, times = {}, {}

    # fp32 K1 and K3 on both paths
    for name, B, S, kv_bf16, full in (("as2pl", 8, 64, True, False), ("map self-attention", 8, 1024, False, True),
                                      ("latent as2pl", 8, 1216, False, False)):
        q, k, v, invalid = attention_case(torch, 7, B, S, 1024, kv_bf16, full, dev)
        digests[f"K1 {name}"] = digest(FA.fused_attention_core(q, k, v, invalid, 4))
        times[f"K1 {name}"] = graph_ms(torch, lambda: FA.fused_attention_core(q, k, v, invalid, 4))
        digests[f"K1-bf16 {name}"] = digest(FA.fused_attention_core(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                                    invalid, 4).float())  # bf16 -> fp32 is exact
        if name == "latent as2pl":
            continue
        q, k, v = q.float(), k.float(), v.float()
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(dev)
        out, rmax, rsum = AT._launch_fwd(q, k, v, invalid, 4, 0.1, 987654321, 3)
        grads = AT._launch_bwd(q, k, v, invalid, out, rmax, rsum, g, 4, 0.1, 987654321, 3)
        digests[f"K3f {name}"] = digest(torch.cat([out.flatten(), rmax.flatten(), rsum.flatten()]))
        for grad, what in zip(grads, ("dq", "dk", "dv")):
            digests[f"K3b {name} {what}"] = digest(grad)
        times[f"K3f {name}"] = graph_ms(torch, lambda: AT._launch_fwd(q, k, v, invalid, 4, 0.1, 987654321, 3))
        times[f"K3b {name}"] = graph_ms(
            torch, lambda: AT._launch_bwd(q, k, v, invalid, out, rmax, rsum, g, 4, 0.1, 987654321, 3))

    # fp32 K2, K4f and K4b
    enc, x, valid, g = node_trace.inputs("cuda")
    weights = [getattr(enc, n) for n in NE.W_NAMES]
    L, H, p, seed = enc.n_layer, enc.n_head, 0.1, 2**50 + 9
    with torch.no_grad():
        digests["K2"] = digest(enc.encode_pooled(x, valid))
        digests["K2-bf16"] = digest(enc.encode_pooled(x, valid, bf16=True))
        digests["K4f"] = digest(NT._launch_fwd(x, valid, p, seed, L, H, weights))
        dx, dw = NT._launch_bwd(x, valid, g, p, seed, L, H, weights)
        digests["K4b"] = digest(torch.cat([dx.flatten(), dw]))
        del dx, dw  # K4b's 3 GB of scratch went with its call
    gen = torch.Generator().manual_seed(5)
    q6, k6, v6 = (torch.randn(x.shape, generator=gen).to(dev) for _ in range(3))
    digests["K6"] = digest(BA.block_attn_core(q6, k6, v6, valid, 4))

    # K1-bf16 beside SDPA on the same bf16 q/k/v, K2-bf16 beside K2
    for name, B, S in (("rollout as2pl", 8, 64), ("joint futures rollout as2pl", 48, 64),
                       ("map polyline self-attention", 8, 1024), ("latent as2pl", 8, 1216)):
        q, k, v, invalid = attention_case(torch, 16, B, S, 1024, True, False, dev)
        q = q.bfloat16()
        qh, kh, vh = (t.view(t.shape[0], t.shape[1], 4, 32).transpose(1, 2) for t in (q, k, v))
        allowed = (~invalid)[:, None]
        times[f"K1-bf16 {name}"] = graph_ms(torch, lambda: FA.fused_attention_core(q, k, v, invalid, 4))
        times[f"SDPA bf16 {name}"] = graph_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed))
    with torch.no_grad():
        times["K2-bf16"] = graph_ms(torch, lambda: enc.encode_pooled(x, valid, bf16=True), n=5)
        times["K2"] = graph_ms(torch, lambda: enc.encode_pooled(x, valid), n=5)
        times["K4f"] = graph_ms(torch, lambda: NT._launch_fwd(x, valid, p, seed, L, H, weights), n=5)
        times["K4b"] = graph_ms(torch, lambda: NT._launch_bwd(x, valid, g, p, seed, L, H, weights), n=3)
    times["K6-bf16"] = graph_ms(torch, lambda: BA.block_attn_core(q6, k6, v6, valid, 4, bf16=True))
    times["K6"] = graph_ms(torch, lambda: BA.block_attn_core(q6, k6, v6, valid, 4))
    return dict(root=root, digests=digests, device_ms=times, card=card_line())


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one_tree(sys.argv[2])), flush=True)
        return
    runs = []
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"tensor_core_ab: the run of {root} failed:\n{out.stdout}\n{out.stderr}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    first = runs[0]["digests"]
    same = {key: all(r["digests"].get(key) == first[key] for r in runs) for key in first}
    print(json.dumps({"digests equal across every run": same}), flush=True)


if __name__ == "__main__":
    main()
