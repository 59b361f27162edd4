"""String keys shared between the data layer, the feature pipeline and the
losses.

Counterpart of ``adanerf_tpu/pipeline/keys.py``, with the same strings, so
the inference dicts of the two packages use the same keys.
"""


class FSK:
    input_feature_batch = 'InputFeatureBatch'
    network_output = 'NetworkOutputBatch'
    postprocessed_network_output = 'PostProcessedNetworkOutput'
    input_feature_ray_directions = "InputFeatureRayDirections"
    input_feature_ray_origins = "InputFeatureRayOrigins"
    nerf_weights_output = "NeRFWeightsOutput"
    nerf_input_feature_z_vals = "NeRFInputFeatureZVals"
    nerf_estimated_depth = "NeRFOutputDepth"
    nerf_input_feature_ray_directions = input_feature_ray_directions
    nerf_input_feature_ray_origins = input_feature_ray_origins
    input_depth_groundtruth = "InputDepthGroundtruth"
    input_depth_groundtruth_world = "InputDepthGroundtruthWorld"
    input_depth_range = "InputDepthRange"
    input_depth = "InputDepth"
    quantization_max_weight = "QuantizationMaxWeight"
    quantized_weights = "QuantizedWeights"
    output_depth_map = "OutputDepthMap"
    adaptive_sample_positions = "AdaptiveSamplePositions"
    adaptive_sample_mask = "AdaptiveSampleMask"  # (rays, S) bool validity of each slot
    oracle_weights = "OracleWeights"
    nerf_alpha_output = "NeRFAlphaOutput"


class DatasetKeys:
    color_image_full = "ColorImageFull"
    color_image_samples = "ColorImageSamples"
    depth_image_full = "DepthImageFull"
    depth_image_samples = "DepthImageSamples"
    image_sample_indices = "ImageSampleIndices"
    image_pose = "ImagePose"
    image_rotation = "ImageRotation"
    ray_directions = "RayDirections"
    image_file_names = "FileNames"
    ray_directions_samples = "RayDirectionsSamples"
    batch_input_dir = "BatchInputDir"
    train_target = "TrainTarget"
    sample_placement = "SamplePlacement"
    batch_0 = "Batch0"
