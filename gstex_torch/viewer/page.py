"""Embedded single-page viewer UI (orbit controls + paint panel)."""

PAGE_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gstex-torch viewer</title>
<style>
 body{margin:0;background:#14161f;color:#dde;font-family:sans-serif;display:flex}
 #panel{width:240px;padding:12px;background:#1c1f2b;font-size:13px}
 #panel h3{margin:8px 0 4px}
 #view{flex:1;display:flex;align-items:center;justify-content:center}
 #img{max-width:100%;max-height:100vh;cursor:grab}
 button,select,input{width:100%;margin:2px 0;background:#2a2e3f;color:#dde;
   border:1px solid #444;border-radius:4px;padding:4px}
 .stat{color:#9ab}
</style></head><body>
<div id="panel">
 <h3>gstex-torch</h3>
 <div class="stat" id="stats">connecting…</div>
 <button id="pause">Pause training</button>
 <h3>Output</h3>
 <select id="output">
  <option>rgb</option><option>depth</option><option>accumulation</option>
  <option>test</option><option>uv</option><option>edit</option>
  <option>clean_normal_img</option><option>only_rgb</option>
  <option>only_texture</option>
 </select>
 <label>Colormap <select id="cmap">
  <option>depth</option><option>turbo</option><option>gray</option>
 </select></label>
 <label>Max res <select id="maxres">
  <option>96</option><option>192</option><option>384</option>
  <option selected>768</option>
 </select></label>
 <h3>Crop box</h3>
 <label><input type="checkbox" id="cropOn" style="width:auto"> enable</label>
 <input id="cropMin" value="-2,-2,-2" title="min x,y,z">
 <input id="cropMax" value="2,2,2" title="max x,y,z">
 <h3>Render path</h3>
 <button id="addKf">Add keyframe</button>
 <button id="clearKf">Clear keyframes</button>
 <label>Seconds <input id="pathSecs" value="4"></label>
 <button id="exportPath">Export camera_path.json</button>
 <div class="stat" id="pathInfo"></div>
 <h3>Texture painting</h3>
 <label>Colour <input type="color" id="lineColor" value="#ff0000"></label>
 <label>Width <input type="range" id="lineWidth" min="1" max="20" value="5"></label>
 <button id="startPoly">Start Polyline</button>
 <button id="endPoly" disabled>End Polyline</button>
 <button id="undoPoly">Undo Polyline</button>
 <button id="saveEdit">Save Edit</button>
</div>
<div id="view"><img id="img" width="768" height="768"></div>
<script>
const H=800, W=800, FOCAL=1111;
const CID=Math.random().toString(36).slice(2,10); // per-tab render slot
let az=0.6, el=0.4, dist=4.0, painting=false;
function c2w(){
 const ce=Math.cos(el), se=Math.sin(el), ca=Math.cos(az), sa=Math.sin(az);
 const eye=[dist*ce*sa, dist*se, dist*ce*ca];
 const f=[-eye[0]/dist,-eye[1]/dist,-eye[2]/dist];
 let up=[0,1,0];
 let r=[f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
 const rn=Math.hypot(...r); r=r.map(v=>v/rn);
 const u=[r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
 return [[r[0],u[0],-f[0],eye[0]],[r[1],u[1],-f[1],eye[1]],[r[2],u[2],-f[2],eye[2]]];
}
function camera(){return {fx:FOCAL,fy:FOCAL,cx:W/2,cy:H/2,height:H,width:W,c2w:c2w()};}
async function requestRender(){
 await fetch('/render',{method:'POST',body:JSON.stringify(
   {camera:camera(),output:document.getElementById('output').value,
    client:CID})});
}
async function poll(){
 try{
  const r=await fetch('/frame?client='+CID+'&t='+Date.now());
  if(r.status==200){
   const blob=await r.blob();
   document.getElementById('img').src=URL.createObjectURL(blob);
  }
  const s=await (await fetch('/state')).json();
  document.getElementById('stats').textContent=
   `step ${s.step} · ${s.num_gaussians} gaussians · ${s.texel_count} texels · ${s.edits} edits`;
  document.getElementById('pause').textContent=
   s.paused?'Resume training':'Pause training';
 }catch(e){}
 setTimeout(poll,120);
}
const img=document.getElementById('img');
let drag=false,lx=0,ly=0;
img.addEventListener('mousedown',e=>{drag=true;lx=e.clientX;ly=e.clientY;});
window.addEventListener('mouseup',()=>drag=false);
window.addEventListener('mousemove',e=>{
 if(!drag||painting)return;
 az-=(e.clientX-lx)*0.01; el=Math.max(-1.4,Math.min(1.4,el+(e.clientY-ly)*0.01));
 lx=e.clientX;ly=e.clientY;requestRender();
});
img.addEventListener('wheel',e=>{e.preventDefault();
 dist=Math.max(0.5,Math.min(20,dist*(1+e.deltaY*0.001)));requestRender();});
img.addEventListener('click',async e=>{
 if(!painting)return;
 const rect=img.getBoundingClientRect();
 await fetch('/control',{method:'POST',body:JSON.stringify({action:'click',
   x:(e.clientX-rect.left)/rect.width, y:(e.clientY-rect.top)/rect.height})});
 requestRender();
});
document.getElementById('pause').onclick=async()=>{
 const s=await (await fetch('/state')).json();
 await fetch('/control',{method:'POST',body:JSON.stringify(
   {action:s.paused?'resume':'pause'})});
};
document.getElementById('startPoly').onclick=async()=>{
 painting=true;
 document.getElementById('startPoly').disabled=true;
 document.getElementById('endPoly').disabled=false;
 const c=document.getElementById('lineColor').value;
 const rgb=[parseInt(c.substr(1,2),16),parseInt(c.substr(3,2),16),parseInt(c.substr(5,2),16)];
 await fetch('/control',{method:'POST',body:JSON.stringify({action:'set_line',
   rgb:rgb,width:+document.getElementById('lineWidth').value})});
 await fetch('/control',{method:'POST',body:JSON.stringify(
   {action:'start_polyline',camera:camera()})});
};
document.getElementById('endPoly').onclick=async()=>{
 painting=false;
 document.getElementById('startPoly').disabled=false;
 document.getElementById('endPoly').disabled=true;
 await fetch('/control',{method:'POST',body:JSON.stringify({action:'end_polyline'})});
 document.getElementById('output').value='edit';
 requestRender();
};
document.getElementById('undoPoly').onclick=async()=>{
 await fetch('/control',{method:'POST',body:JSON.stringify({action:'undo'})});
 requestRender();
};
document.getElementById('saveEdit').onclick=async()=>{
 await fetch('/control',{method:'POST',body:JSON.stringify({action:'save'})});
};
document.getElementById('output').onchange=requestRender;
document.getElementById('cmap').onchange=async e=>{
 await fetch('/control',{method:'POST',body:JSON.stringify(
   {action:'set_colormap',name:e.target.value})});requestRender();};
document.getElementById('maxres').onchange=async e=>{
 await fetch('/control',{method:'POST',body:JSON.stringify(
   {action:'set_max_res',max_res:+e.target.value})});requestRender();};
async function sendCrop(){
 const on=document.getElementById('cropOn').checked;
 const mn=document.getElementById('cropMin').value.split(',').map(Number);
 const mx=document.getElementById('cropMax').value.split(',').map(Number);
 await fetch('/control',{method:'POST',body:JSON.stringify(
   {action:'set_crop',enabled:on,min:mn,max:mx})});requestRender();}
document.getElementById('cropOn').onchange=sendCrop;
document.getElementById('cropMin').onchange=sendCrop;
document.getElementById('cropMax').onchange=sendCrop;
document.getElementById('addKf').onclick=async()=>{
 const r=await (await fetch('/panel',{method:'POST',body:JSON.stringify(
   {action:'add_keyframe',camera:camera()})})).json();
 document.getElementById('pathInfo').textContent=r.keyframes+' keyframes';};
document.getElementById('clearKf').onclick=async()=>{
 const r=await (await fetch('/panel',{method:'POST',body:JSON.stringify(
   {action:'clear_keyframes'})})).json();
 document.getElementById('pathInfo').textContent=r.keyframes+' keyframes';};
document.getElementById('exportPath').onclick=async()=>{
 const r=await (await fetch('/panel',{method:'POST',body:JSON.stringify(
   {action:'export',seconds:+document.getElementById('pathSecs').value})}))
   .json();
 document.getElementById('pathInfo').textContent='saved '+(r.path||'');};
requestRender();poll();
</script></body></html>
"""
