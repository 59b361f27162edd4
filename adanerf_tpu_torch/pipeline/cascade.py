"""The model cascade: oracle -> sampler -> shading -> composite.

Counterpart of ``adanerf_tpu/pipeline/cascade.py``: each stage's input
feature set builds the MLP input from the batch and the previous stages'
outputs, the model runs, and the input feature set's postprocess composites.
Only the input feature sets' postprocess runs, so the oracle's output
reaches the sampler as raw logits.
"""

from __future__ import annotations

from typing import Dict, List

from .keys import FSK


def run_cascade(models, f_in, batch: Dict, is_inference=False, generator=None,
                dtype=None, apply_fns=None):
    """Run all stages; returns (postprocessed_outs, inference_dicts).

    models: the stages' modules (BaseNetDef / NeRFDef); f_in: their input
    FeatureSets; batch: a DatasetKeys dict of tensors. apply_fns: optional
    per-stage replacement of ``models[i](x, dtype)``, taking x only; the train
    step routes the shading MLP through the K3 kernel with it.
    """
    postprocessed = []
    dicts: List[Dict] = []
    for i, model in enumerate(models):
        d = f_in[i].batch(batch, prev_outs=dicts, is_inference=is_inference,
                          generator=generator)
        x = d[FSK.input_feature_batch]
        if apply_fns is not None and apply_fns[i] is not None:
            d[FSK.network_output] = apply_fns[i](x)
        else:
            d[FSK.network_output] = model(x, dtype)
        f_in[i].postprocess(d, batch)
        postprocessed.append(d[FSK.postprocessed_network_output])
        dicts.append(d)
    return postprocessed, dicts
