from .nca import CA_PARAMS_INIT, ca_step, init_params, perception, rollout, seed, to_rgb, train_nca  # noqa: F401
