#!/usr/bin/env python3
"""How far SDMGR's UNet16 map on the card lies from the CPU's and from a
float64 reference.

    python tools/torch_kie_precision.py [--cpu-only] [--step]

Builds the UNet of ``configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py``
with ``init_kie_weights(chip_smoke.SEED)`` in eval mode, feeds it
``chip_smoke.B_KIE`` random normalised pages of the config's 512 x 512,
and prints, for the map after
each stage (``enc0`` .. ``enc4``, ``dec3`` .. ``dec0``) and for the 7x7
RoI max pool of 64 random boxes, the largest magnitude and the largest
difference over it:

* float32 on the CPU against float64 on the CPU;
* float32 on the card (TF32 off) against float64, with cuDNN's default
  algorithms, its deterministic ones, and cuDNN off (ATen's own
  convolutions).

So a gap between the card and the CPU can be put on one side: the side
farther from float64 carries it. Needs a CUDA GPU; the CPU rows alone run
without one (``--cpu-only``).

``--step`` instead takes ``chip_smoke.kie_ner_phase``'s one f32 training
step of SDMGR-UNet16 (its receipts, B=4, train-mode BatchNorm) and prints
the loss, the gradient norm and each module's gradient norm in float64 on
the CPU, float32 on the CPU, float32 on the card with cuDNN's default
algorithms, its deterministic ones and cuDNN off, and float64 on the card,
each one's largest gradient difference from the CPU's float64 (over that
module's largest gradient), and how many pooled visual features are an
exact 0 (a dead ReLU region under the RoI) on one side and not on the
other. Then, for each linear layer of the head, the largest difference
of the gradient at its output from the CPU's float64 (over the largest
of that gradient), and for the GNN layers' ``in_fc`` and ``out_fc``, which
a ReLU follows, how many of their outputs have the other sign than in
float64 (ReLU flips; padded pairs included).
"""
import argparse
import copy
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tps_pp_tpu_torch.apis.train_kie import init_kie_weights  # noqa: E402
from tps_pp_tpu_torch.config import load_config  # noqa: E402
from tps_pp_tpu_torch.models.kie import build_sdmgr  # noqa: E402
from tps_pp_tpu_torch.models.kie.sdmgr import roi_visual_pool  # noqa: E402
from tps_pp_tpu_torch.models.layers import max_pool, resize_bilinear  # noqa

CONFIG = 'configs/kie/sdmgr/sdmgr_unet16_60e_wildreceipt.py'
SIZE = 512      # the config's img_size


def stages(unet, x):
    """The UNet's forward on NHWC ``x``, returning each stage's NCHW map
    by name and the final NHWC map."""
    out = {}
    x = x.permute(0, 3, 1, 2)
    skips = []
    for i in range(unet.num_stages):
        if i:
            x = max_pool(x, 2, 2)
        x = getattr(unet, f'enc{i}')(x)
        out[f'enc{i}'] = x
        skips.append(x)
    for i in range(unet.num_stages - 2, -1, -1):
        x = resize_bilinear(x, skips[i].shape[2:])
        x = getattr(unet, f'up{i}')(x)
        x = getattr(unet, f'dec{i}')(torch.cat([skips[i], x], dim=1))
        out[f'dec{i}'] = x
    return out, x.permute(0, 2, 3, 1)


def run(model, img, boxes):
    with torch.inference_mode():
        maps, fm = stages(model.backbone, img)
        maps['pooled'] = roi_visual_pool(fm, boxes)
    return {k: v.double().cpu() for k, v in maps.items()}


def step_grads(model, batch, loss_fn):
    """One train-mode forward and backward: (loss, the pooled features,
    each parameter's gradient, each head linear layer's output and the
    gradient at it by name), in the model's dtype and device."""
    model = model.train()
    relations, texts, labels, edge_labels, img, boxes = batch
    model.zero_grad()
    outs, handles = {}, []

    def keep(name):
        def hook(_, __, y):
            outs[name] = [y.detach().double().cpu(), None]
            y.register_hook(
                lambda g: outs[name].__setitem__(1, g.double().cpu()))
        return hook
    for name, m in model.head.named_modules():
        if isinstance(m, torch.nn.Linear):
            handles.append(m.register_forward_hook(keep(name)))
    pooled = model.visual_features(img, boxes)
    node, edge = model.head(relations, texts, pooled)
    C = node.shape[-1]
    losses = loss_fn(node.reshape(-1, C), edge.reshape(-1, 2),
                     labels.reshape(-1), edge_labels.reshape(-1))
    loss = sum(losses.values())
    loss.backward()
    for h in handles:
        h.remove()
    return (float(loss.detach()), pooled.detach().double().cpu(),
            {n: p.grad.double().cpu() for n, p in model.named_parameters()},
            outs)


def step_report(cpu_only):
    import tempfile

    import numpy as np

    import chip_smoke as cs
    from tps_pp_tpu_torch.apis.train_kie import KIE_KEYS, build_task_dataset
    from tps_pp_tpu_torch.config import merge_cli_options
    from tps_pp_tpu_torch.registry import LOSSES
    from tps_pp_tpu_torch.tools.test import parse_cfg_options
    with tempfile.TemporaryDirectory() as d:
        files, images = cs.kie_ner_data(d, np.random.default_rng(cs.SEED + 24))
        cfg = merge_cli_options(load_config(os.path.join(ROOT, CONFIG)),
                                parse_cfg_options(cs.kie_ner_options(
                                    'unet16', files, d)))
        ds = build_task_dataset(cfg, 'train', images=images)
        batch = [torch.from_numpy(np.stack([ds[i][k] for i in
                                            range(cs.B_KIE)]))
                 for k in KIE_KEYS + ('img', 'boxes')]
    base = init_kie_weights(build_sdmgr(cfg['model'], True), cs.SEED)
    loss_fn = LOSSES.build(dict(cfg['model']['loss']))
    runs = {'cpu f64': step_grads(copy.deepcopy(base).double(), [
        b.double() if b.is_floating_point() else b for b in batch], loss_fn),
        'cpu f32': step_grads(copy.deepcopy(base), batch, loss_fn)}
    if not cpu_only:
        cudnn = torch.backends.cudnn
        for name, det, on in (('card f32', False, True),
                              ('card f32 det', True, True),
                              ('card f32 no cuDNN', False, False)):
            cudnn.deterministic, cudnn.enabled = det, on
            runs[name] = step_grads(copy.deepcopy(base).cuda(),
                                    [b.cuda() for b in batch], loss_fn)
        cudnn.deterministic, cudnn.enabled = False, True
        runs['card f64'] = step_grads(copy.deepcopy(base).double().cuda(), [
            (b.double() if b.is_floating_point() else b).cuda()
            for b in batch], loss_fn)
    groups = {}
    for n in runs['cpu f64'][2]:
        groups.setdefault('.'.join(n.split('.')[:2]), []).append(n)
    _, ref_pool, ref, ref_outs = runs['cpu f64']
    for name, (loss, pool, grads, _) in runs.items():
        total = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        print(f'{name}: loss {loss:.9g}, grad norm {total:.9g}, pooled '
              f'zeros {int((pool == 0).sum())} (float64: '
              f'{int((ref_pool == 0).sum())}, parting '
              f'{int(((pool == 0) != (ref_pool == 0)).sum())})')
    for grp, names in groups.items():
        cells = []
        for name, (_, _, grads, _) in runs.items():
            norm = float(torch.sqrt(sum((grads[n] ** 2).sum()
                                        for n in names)))
            gap = (max(float((grads[n] - ref[n]).abs().max())
                       for n in names)
                   / max(float(ref[n].abs().max()) for n in names))
            cells.append(f'{name} {norm:.6g} ({gap:.2e})')
        print(f'  {grp:24} ' + '; '.join(cells))
    print('the gradient at each head layer\'s output (largest difference '
          'over its largest); ReLU flips')
    for layer, (y_ref, g_ref) in ref_outs.items():
        cells = []
        for name, (_, _, _, outs) in runs.items():
            y, g = outs[layer]
            gap = float((g - g_ref).abs().max() / g_ref.abs().max())
            cell = f'{name} {gap:.2e}'
            if layer.endswith(('in_fc', 'out_fc')):
                cell += f', {int(((y > 0) != (y_ref > 0)).sum())} flips'
            cells.append(cell)
        print(f'  {layer:24} ' + '; '.join(cells))


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--cpu-only', action='store_true')
    p.add_argument('--step', action='store_true')
    args = p.parse_args()
    if not args.cpu_only and not torch.cuda.is_available():
        sys.exit('torch_kie_precision: no CUDA device (pass --cpu-only)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.step:
        return step_report(args.cpu_only)
    import chip_smoke as cs
    cfg = load_config(os.path.join(ROOT, CONFIG))['model']
    model = init_kie_weights(build_sdmgr(cfg, visual=True), cs.SEED).eval()
    g = torch.Generator().manual_seed(cs.SEED)
    img = torch.randn(cs.B_KIE, SIZE, SIZE, 3, generator=g)
    xy = torch.rand(cs.B_KIE, 64, 2, generator=g) * (SIZE - 64)
    wh = torch.rand(cs.B_KIE, 64, 2, generator=g) * 60 + 2
    boxes = torch.cat([xy, xy + wh], -1)
    ref = run(copy.deepcopy(model).double(), img.double(), boxes.double())
    rows = {'cpu f32': run(model, img, boxes)}
    if not args.cpu_only:
        card = copy.deepcopy(model).cuda()
        x, b = img.cuda(), boxes.cuda()
        cudnn = torch.backends.cudnn
        rows['card, cuDNN default'] = run(card, x, b)
        cudnn.deterministic = True
        rows['card, cuDNN deterministic'] = run(card, x, b)
        cudnn.deterministic, cudnn.enabled = False, False
        rows['card, cuDNN off'] = run(card, x, b)
        cudnn.enabled = True
        rows['card - cpu f32 (default)'] = None
    print(f'UNet16 seed {cs.SEED}, B={cs.B_KIE}, {SIZE}x{SIZE};'
          ' largest |x| of the float64 map, then each row\'s largest '
          'difference over it')
    print('stage    ' + '  '.join(f'{k:>14}' for k in ref))
    print('max|x|   ' + '  '.join(f'{float(v.abs().max()):14.4g}'
                                  for v in ref.values()))
    for name, got in rows.items():
        if got is None:
            got, base = rows['card, cuDNN default'], rows['cpu f32']
        else:
            base = ref
        gaps = [float((got[k] - base[k]).abs().max() / ref[k].abs().max())
                for k in ref]
        print(f'{name}: ' + '  '.join(f'{e:14.3g}' for e in gaps))


if __name__ == '__main__':
    main()
