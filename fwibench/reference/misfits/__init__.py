"""The reference's misfits, one module a name of the drivers' ``--misfit``
numbering (``objective.MISFITS``), each with a function ``misfit(syn, obs,
dw) -> (value as a float in float64, residual)`` of the synthetic,
observed and direct-wave traces (shots, time, receivers), the residual
being the value's cotangent of ``syn``, which the adjoint sweep injects.
``objective.find`` loads the workload's from its file: a new misfit is a
new file here."""
