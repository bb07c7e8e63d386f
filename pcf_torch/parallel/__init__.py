from pcf_torch.parallel.mesh import (make_eager_eval_step, make_eager_train_step,
                                     make_eval_step, make_train_step, step_seed)
