"""The PAVE vehicle-damage pipeline of the port (the JAX package's pave/):
a car segmentor seeds a bounding box, 512x512 sliding-window crops around it
go through the detector, the detections are translated back to the frame
and NMS-merged, and precision / recall are scored per frame."""
