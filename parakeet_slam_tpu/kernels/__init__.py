from parakeet_slam_tpu.kernels import match, resample, schur, score_3d
