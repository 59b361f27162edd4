"""Experiment naming.

Counterpart of ``adanerf_tpu/utils/helper.py``: the experiment directory
name encodes the architecture exactly as the JAX package (and the
reference) writes it, so resume, the dense->fine regex handoff and tools
that parse hyperparameters back out of directory names work across both.
"""

from __future__ import annotations


def config_to_name(in_features, out_features, models, encodings, enc_args_in,
                   losses, loss_weights, loss_components, loss_c_weights,
                   loss_blending_start, loss_blending_duration,
                   loss_alpha, loss_beta):
    """The name of the cascade's stages, losses and loss blending."""
    name = ""
    for i in range(len(in_features)):
        if i > 0:
            name += "_"
        enc_args = f"({enc_args_in[i]})" if enc_args_in[i] not in ["", "none"] else ""
        enc = f"({encodings[i]}{enc_args})" if encodings[i] not in ["", "none"] else ""

        loss_alpha_beta = ""
        if len(loss_alpha) > i and len(loss_beta) > i:
            loss_alpha_beta = f"l{loss_alpha[i]}_{loss_beta[i]}_"

        name += (f"{loss_alpha_beta}{in_features[i].get_string()}{enc}-"
                 f"{models[i].name}-{out_features[i].get_string()}")

    print_loss_weights = False
    temp = ""
    for i, weight in enumerate(loss_weights):
        temp += "_[" if i == 0 else "_"
        temp += f"{weight}"
        print_loss_weights = print_loss_weights or weight != 1.0
    if print_loss_weights:
        temp += "]"
        name += temp

    if loss_blending_start > 0 and loss_blending_duration > 0:
        name += f"_[{loss_blending_start / 1000:g}k_{loss_blending_duration / 1000:g}k]"

    for i, loss in enumerate(losses):
        if loss == "NeRFWeightMultiplicationLoss":
            for j, comp in enumerate(loss_components):
                name += f"_{comp[0]}"
                if loss_c_weights[j] > 0.0:
                    name += f"({loss_c_weights[j]})"
    return name


def experiment_name(config, f_in, f_out, models):
    """Full experiment directory name, with the depth-transform prefix."""
    depth_transform = ""
    if config.depthTransform and config.depthTransform != "linear":
        depth_transform = config.depthTransform[0:2] + "_"
    scale_interpolation = ""
    if config.scaleInterpolation and config.scaleInterpolation != "median":
        scale_interpolation = config.scaleInterpolation[0:2] + "_"
    nerf_depth = "noGT_" if config.useNerfDepthMap else ""
    ndc_str = "ndc_" if config.useNDC else ""
    return ndc_str + nerf_depth + depth_transform + scale_interpolation + \
        config_to_name(f_in, f_out, models, config.posEnc, config.posEncArgs,
                       config.losses, config.lossWeights, config.lossComponents,
                       config.lossComponentBlending, config.lossBlendingStart,
                       config.lossBlendingDuration, config.lossAlpha,
                       config.lossBeta)
