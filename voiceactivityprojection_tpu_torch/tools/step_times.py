"""Host-clock times of the CPC step, of the frozen-encoder train step (in
bfloat16 and in float32, the default dtype), of the float32 train step
with the encoder unfrozen (the default-dtype workload of K9) and of a bf16
inference request, for comparing two trees on one card.

    cd <tree root> && python3 voiceactivityprojection_tpu_torch/tools/step_times.py

Imports the package of the current directory (so this file of one tree
can time another: ``cd <other tree> && python3 <this file>``). CPC at the
pretrain_cpc.py defaults (B=32 x 20480, f32), the frozen step at B=16 x 20
s in bf16 and in f32 and the unfrozen step in f32 (dropout 0.1, AdamW);
each timed as five windows (10 and 6 steps) ending in a synchronize,
after three warm-up steps, and ``VapModel.probs`` at B=64 x 20 s in bf16
as five windows of 6 requests (inference audio-seconds/s is 1,280 over
the ms a request). Prints one JSON line with the windows' milliseconds a
step or request and their medians. Needs an NVIDIA GPU.
"""

import json
import sys
import time

import numpy as np
import torch


def windows(fn, n, reps=5):
    """Milliseconds a step of ``reps`` windows of ``n`` calls of fn(i)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(n):
            fn(100 + i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / n * 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("step_times needs an NVIDIA GPU")
    sys.path.insert(0, ".")
    from voiceactivityprojection_tpu_torch import VapConfig
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
    from voiceactivityprojection_tpu_torch.models.vap import VapNet
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain as cpc
    from voiceactivityprojection_tpu_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = VapConfig()
    rng = np.random.default_rng(1)
    tree = ckpt.random_params_tree(conf, seed=0)
    heads = cpc.init_cpc_heads(torch.Generator().manual_seed(0), 12, 256, 256)
    st = cpc.init_cpc_train_state(ckpt.encoder_from_jax(tree["encoder"]), heads, device="cuda")
    cstep = cpc.make_cpc_train_step(12, 128)
    waves = [torch.as_tensor((0.1 * rng.standard_normal((32, 20480))).astype(np.float32), device="cuda")
             for _ in range(2)]
    cpc_ms = windows(lambda i: cstep(st, waves[i % 2], torch.Generator().manual_seed(i)), 10)
    del st, waves
    state = ckpt.params_from_jax(tree, conf)
    c16 = VapConfig(dtype="bfloat16")
    batches = [{"waveform": torch.as_tensor((0.1 * rng.standard_normal((16, 2, 320000))).astype(np.float32),
                                            device="cuda"),
                "vad": torch.as_tensor((rng.random((16, 1100, 2)) < 0.4).astype(np.float32), device="cuda")}
               for _ in range(2)]
    frozen = {}
    for c in (c16, conf):
        net = VapNet(c)
        net.load_state_dict(state)
        net.to("cuda")
        step = tstep.make_train_step(c, tstep.make_optimizer(OptConfig(), net, True))
        frozen[c.dtype] = windows(lambda i: step(net, batches[i % 2], torch.Generator().manual_seed(i)), 6)
        del net, step
    frozen_ms = frozen["bfloat16"]
    unfrozen = VapConfig(freeze_encoder=False)
    net = VapNet(unfrozen)
    net.load_state_dict(state)
    net.to("cuda")
    step = tstep.make_train_step(unfrozen, tstep.make_optimizer(OptConfig(), net, False))
    unfrozen_ms = windows(lambda i: step(net, batches[i % 2], torch.Generator().manual_seed(i)), 6)
    del net, step, batches
    from voiceactivityprojection_tpu_torch import VapModel

    model = VapModel(c16, state, device="cuda")
    reqs = [torch.as_tensor((0.1 * rng.standard_normal((64, 2, 320000))).astype(np.float32), device="cuda")
            for _ in range(2)]
    probs_ms = windows(lambda i: model.probs(reqs[i % 2]), 6)
    print(json.dumps({"cpc_ms_per_step": cpc_ms, "cpc_median": float(np.median(cpc_ms)),
                      "frozen_ms_per_step": frozen_ms, "frozen_median": float(np.median(frozen_ms)),
                      "frozen_f32_ms_per_step": frozen["float32"],
                      "frozen_f32_median": float(np.median(frozen["float32"])),
                      "unfrozen_f32_ms_per_step": unfrozen_ms, "unfrozen_f32_median": float(np.median(unfrozen_ms)),
                      "probs_ms_per_request": probs_ms, "probs_median": float(np.median(probs_ms))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
