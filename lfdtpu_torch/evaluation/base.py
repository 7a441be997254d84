# The port's copy of `lfdtpu/evaluation/base.py` (numpy only; the port imports
# nothing of lfdtpu).
#
# Evaluator protocol (reference `lfd/evaluation/base_evaluator.py:6-12`).


class Evaluator:
    def update(self, results, meta_batch=None):
        raise NotImplementedError

    def evaluate(self):
        raise NotImplementedError

    def get_eval_display_str(self):
        return ""
