"""Framework front ends (TensorFlow: `bindings.tf_binding`, imported on its
own, so that torch users need no TensorFlow)."""
