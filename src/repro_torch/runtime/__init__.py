"""``repro_torch.runtime`` — runtime helpers of the port: the straggler
monitor (:mod:`repro_torch.runtime.straggler`), whose
:meth:`~repro_torch.runtime.straggler.StragglerMonitor.late` is the
streaming runner's one definition of a late batch."""
