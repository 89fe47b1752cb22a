"""Networks, bootstrap dynamics and measurement, and the filter engine."""
