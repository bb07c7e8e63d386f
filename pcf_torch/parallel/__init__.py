from pcf_torch.parallel.mesh import make_eval_step, make_train_step, step_seed
